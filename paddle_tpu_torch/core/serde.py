"""Program (de)serialization: the JSON descriptor layer (parity: the JAX
package's ``core/serde.py``; used by ``io.save_inference_model`` and
``io.load_inference_model``). The JSON is the JAX package's key for key,
so a Program written by either package loads in the other.

Grad ops hold their forward op; the descriptor records its (block, op
index), and the loader links the op back.
"""

import json

import numpy as np

from .. import framework

__all__ = ["program_to_desc", "program_from_desc", "program_from_json"]


def program_to_desc(program):
    return {"version": 1, "random_seed": program.random_seed,
            "blocks": [blk.to_desc() for blk in program.blocks]}


def program_from_desc(desc):
    p = framework.Program()
    p.random_seed = desc.get("random_seed", 0)
    p.blocks = [framework.Block(p, bd["idx"], bd["parent_idx"])
                for bd in desc["blocks"]]
    for bd, blk in zip(desc["blocks"], p.blocks):
        for vd in bd["vars"]:
            common = dict(
                name=vd["name"],
                lod_level=vd.get("lod_level", 0),
                stop_gradient=vd.get("stop_gradient", False),
                is_data=vd.get("is_data", False),
                type=vd.get("type"),
            )
            if vd.get("is_parameter"):
                v = framework.Parameter(
                    blk, shape=vd["shape"], dtype=vd["dtype"],
                    trainable=vd.get("trainable", True), **common)
            else:
                v = framework.Variable(
                    blk, shape=vd["shape"], dtype=vd["dtype"],
                    persistable=vd.get("persistable", False), **common)
            blk.vars[v.name] = v
    for bd, blk in zip(desc["blocks"], p.blocks):
        for od in bd["ops"]:
            attrs = {}
            for k, v in od["attrs"].items():
                if isinstance(v, dict) and "__block__" in v:
                    attrs[k] = p.blocks[v["__block__"]]
                elif isinstance(v, dict) and "__ndarray__" in v:
                    attrs[k] = np.asarray(v["__ndarray__"], dtype=v["dtype"])
                else:
                    attrs[k] = v
            blk.append_op(
                type=od["type"],
                inputs={k: [blk.var(n) for n in ns]
                        for k, ns in od["inputs"].items()},
                outputs={k: [blk.var(n) for n in ns]
                         for k, ns in od["outputs"].items()},
                attrs=attrs)
    # link grad ops back to their forward ops
    for blk in p.blocks:
        for op in blk.ops:
            ref = op.attrs.get("__fwd_op__")
            if isinstance(ref, dict) and "__op_index__" in ref:
                op.attrs["__fwd_op__"] = \
                    p.blocks[ref["__op_block__"]].ops[ref["__op_index__"]]
    p.current_block_idx = 0
    return p


def program_from_json(s):
    return program_from_desc(json.loads(s))
