"""Per-source nvcc wall times of the port's kernel build.

    python3 tools/build_times.py CHECKOUT

Starts one nvcc a source of CHECKOUT's ``qbold_vi_tpu_torch/csrc`` (its
``ops/_cuda.py`` SOURCES, with its NVCC_FLAGS), every one at once as
``_cuda.library()`` starts them, objects to a scratch directory, and prints
each source's wall time from the start and its exit code, fastest first:
the slowest source bounds the build. Needs nvcc (the machine with the
card); builds nothing the package uses.
"""

import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, sys.argv[1])
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402

out = Path(tempfile.mkdtemp())
t0 = time.time()
procs = {s: subprocess.Popen([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-c", "-o",
                              str(out / (Path(s).stem + ".o")),
                              str(_cuda.CSRC / s)],
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.DEVNULL)
         for s in _cuda.SOURCES}
done = {}
while len(done) < len(procs):
    for s, p in procs.items():
        if s not in done and p.poll() is not None:
            done[s] = (time.time() - t0, p.returncode)
    time.sleep(0.2)
print(f"{sys.argv[1]}: " + ", ".join(
    f"{s} {t:.1f} s (rc {rc})"
    for s, (t, rc) in sorted(done.items(), key=lambda kv: kv[1][0])))
