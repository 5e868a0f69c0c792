"""What the port's CUDA kernels compile to: registers, stack and spills.

    python3 -m ray_tpu_torch.kernel_report      # needs nvcc, not a GPU

Compiles every source of ``ray_tpu_torch/csrc`` (``_kernels.SOURCES``)
with the flags the port builds with plus ``-Xptxas -v``, one ``nvcc`` per
source, all started together, and prints the nvcc version, then one JSON
line per kernel instantiation: its name with template arguments,
registers a thread, stack frame and spill bytes, and ptxas's notes on
wgmma (a serialised product). Exits non-zero if a build fails.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from ray_tpu_torch.ops import _kernels


def ptxas_rows(log: str) -> list[dict]:
    """One row per entry function of a ``-Xptxas -v`` log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            short = re.search(r"(?<=\d)(flash_\w+?_kernel)(I.*?E)?Ev", m.group(1))
            name = short.group(1) + (short.group(2) or "") if short else m.group(1)
            cur = {"kernel": name, "notes": []}
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            if "wgmma" in line.lower():
                cur["notes"].append(line.strip())
    return rows


def main() -> int:
    nvcc = _kernels._nvcc()
    print(subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip()
          .splitlines()[-1])
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(Path(tmp) / f"{src}.so"),
             str(_kernels._CSRC / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src in _kernels.SOURCES}
        failed = False
        for src, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                print(f"nvcc failed for {src}:\n{log}", file=sys.stderr)
                failed = True
                continue
            for row in ptxas_rows(log):
                print(json.dumps({"source": src, **row}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
