"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout.  The
last line of standard output is the result as one JSON object; the last
lines of standard error are the numbers compared with their limits.  Exits
2 without a card (no CPU fallback), 3 when JAX or the JAX package was
loaded.  Build outputs and kernel caches stay in ``build/`` of the
checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton_cache"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = os.path.join(ROOT, "build", sub)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
