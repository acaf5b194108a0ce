"""CPU tests of the benchmark (`pytest chipbench/tests`); the ones that
need a CUDA card carry the `cuda` marker and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# cells shrunk to a size the CPU runs in a second: the program's plain
# versions there, the same code paths and the same limits
TINY = {
    "imdd40.stream_n64": {"instances": 4, "instance_symbols": 2048,
                          "frame_symbols": 1024, "compare_batches": 2},
    "imdd40.stream_n4096": {"instances": 16, "instance_symbols": 512,
                            "frame_symbols": 1024, "compare_batches": 2},
    "proakis_b.sectors_1024": {"rows_per_head": 6, "row_symbols": 1024,
                               "compare_batches": 2},
}


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
