from . import base  # noqa: F401
from . import collective  # noqa: F401
