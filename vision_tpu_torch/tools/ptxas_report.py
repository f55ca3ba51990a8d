"""Registers, shared memory and spills of every CUDA kernel of the package,
as ``ptxas`` reports them: each ``csrc/*.cu`` is compiled once more with the
package's own flags plus ``-Xptxas -v`` (all sources in parallel, into a
temporary directory), and one line per kernel entry is printed.

    python -m vision_tpu_torch.tools.ptxas_report [kernel ...]

Needs ``nvcc``. ``_kernels.build_all`` drops the compiler's output when a
build succeeds, so this is the way to see whether a kernel fits its
``__launch_bounds__`` without spilling.
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from pathlib import Path

from vision_tpu_torch import _kernels


def main() -> int:
    names = sys.argv[1:] or sorted(_kernels._KERNELS)
    nvcc = _kernels._nvcc()
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in names:
            source, extra, _ = _kernels._KERNELS[name]
            cmd = [nvcc, *_kernels._NVCC_FLAGS, *extra, "-Xptxas", "-v",
                   "-o", str(Path(tmp) / f"{name}.so"),
                   str(_kernels._CSRC / source)]
            procs.append((name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for name, proc in procs:
            log, _ = proc.communicate()
            print(f"== {name}: nvcc exit {proc.returncode}")
            if proc.returncode != 0:
                print(log)
                failed += 1
                continue
            entry = "?"
            for line in log.splitlines():
                found = re.search(r"Compiling entry function '(\S+)'", line)
                if found:
                    entry = found.group(1)
                elif "Used" in line and "registers" in line:
                    print(f"{entry}: {line.split(':', 1)[1].strip()}")
                elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                    print(f"{entry}: {line.strip()}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
