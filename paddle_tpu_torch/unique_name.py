"""Unique name generator (parity: python/paddle/fluid/unique_name.py).

`generate(key)` produces names like `fc_0.w_0`; `guard` scopes a fresh
generator (fresh counters inside the guard); `switch` swaps generators by
hand. Names must equal the JAX package's: weights cross between the two
packages by name.
"""

import contextlib

__all__ = ["generate", "switch", "guard"]


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids = {}
        self.prefix = prefix

    def __call__(self, key):
        if key not in self.ids:
            self.ids[key] = 0
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = (new_generator if new_generator is not None
                 else UniqueNameGenerator())
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
