"""JAX ``_stage1_flat`` answers for the flat stage-1 kernels' card tests.

The card's machine has no JAX, so the kernels (``csrc/stage1_select.cu``)
meet the JAX package through ``stage1_jax_golden.npz``: for each case of
``tests/_stage1_cases.py::GOLDEN_CASES`` (numpy-seeded operands, the same
on every machine) the JAX package's ``_stage1_flat`` answer on the CPU and
a checksum of the codes. ``tests/test_torch_retrieval.py`` recomputes
every answer with JAX and holds it to the file bit for bit;
``tests/test_torch_cuda_card.py`` holds the kernels to it.

    JAX_PLATFORMS=cpu python tests/data/make_stage1_jax_golden.py
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]


def main():
    import jax.numpy as jnp
    import numpy as np
    from _stage1_cases import (
        GOLDEN_CASES,
        JAX_GOLDEN,
        codes_sum,
        golden_inputs,
    )

    from large_scale_recommendation_tpu.serving import retrieval as jret

    out = {}
    for name in GOLDEN_CASES:
        args, kc = golden_inputs(name)
        v, r = jret._stage1_flat(*(jnp.asarray(t.numpy()) for t in args),
                                 kc=kc)
        out[name + ".values"], out[name + ".rows"] = np.array(v), np.array(r)
        out[name + ".codes_sum"] = np.int64(codes_sum(args))
    np.savez_compressed(JAX_GOLDEN, **out)


if __name__ == "__main__":
    main()
