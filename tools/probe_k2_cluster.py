"""Where one f32 row's quantize-on-demote can read from, on one CUDA card:
the load and absmax of the demoted blocks of yi-6b, qwen2-moe and
h2o-danube-3-4b (one row each, cycling through a pool larger than the L2)
by ``tools/probe_k2_cluster.cu``, timed from the profiler's trace as
``chip_smoke.py`` times a kernel, with the row's slices

- in one thread block cluster of 16 blocks, reduced through distributed
  shared memory, with and without the int8 quantization after it (the
  design of a cluster per row);
- in 16 blocks without a cluster (the same blocks, placed anywhere);
- in 128 blocks without a cluster (the whole card).

Prints one JSON line of device ms per call:

    python3 tools/probe_k2_cluster.py
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

#: (label, blocks, cluster size, quantize)
LAYOUTS = (("cluster16_quantize", 16, 16, 1),
           ("cluster16_load_absmax", 16, 16, 0),
           ("blocks16_load_absmax", 16, 1, 0),
           ("blocks128_load_absmax", 128, 1, 0))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_k2_cluster: no CUDA card visible", file=sys.stderr)
        return 2
    src = Path(__file__).with_suffix(".cu")
    lib_path = cs.build.BUILD_DIR / "libprobe_k2_cluster.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cs.build._nvcc(), *cs.build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_k2.argtypes = [p, i, i, i, i, p, p]
    lib.probe_k2.restype = i
    out = dict(card=cs.card_line())
    rng = np.random.default_rng(cs.SEED + 9)
    for arch, bs in (("yi-6b", 8), ("qwen2-moe", 8), ("h2o-danube-3-4b", 16)):
        elems = cs.block_elems(cs.get_config(arch), bs)
        pool = torch.from_numpy(rng.normal(size=(64, elems)).astype(
            np.float32)).cuda()
        values = torch.empty((elems,), dtype=torch.uint8, device="cuda")
        nxt = [0]
        for label, blocks, cluster, quant in LAYOUTS:
            def call():
                nxt[0] = (nxt[0] + 1) % 64
                rc = lib.probe_k2(pool[nxt[0]].data_ptr(), elems, blocks,
                                  cluster, quant, values.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc
            out[f"{arch} {label}"], _ = cs.time_ms(call, 200)
        del pool
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
