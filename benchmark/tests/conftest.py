"""Shared pieces of the benchmark's tests: small sizes of every cell for
the CPU, and the card fixture of the ``cuda`` tests."""

from __future__ import annotations

import pytest

# every cell at a size the CPU's plain versions hold in seconds; but for
# the 100 bp cell, scores still past 8 bits so that the 8-bit control
# fails (the gap control fails at every length)
SMALL = {
    "swissprot.search": {
        "config": {"database": {"entries": 400},
                   "queries": {"lengths": [144, 375, 567]},
                   "homologs": {"share": 0.1},
                   "sequences": {"length": {"mean": 40}}},
        "traffic": {"refs_per_call": 32, "sample": {"size": 24}}},
    "wfa.10k_e5.cigar": {
        "traffic": {"length": 600, "pool": 8, "per_call": 4,
                    "sample": {"size": 4}}},
    "swissprot.hits.cigar": {
        "config": {"sequences": {"length": {"mean": 60}}},
        "traffic": {"pool": 64, "per_call": 16, "sample": {"size": 16}}},
    "wfa.1k_e5.single": {
        "traffic": {"length": 600, "pool": 8, "sample": {"size": 4}}},
    "wfa.10k_e5.score": {
        "traffic": {"length": 600, "pool": 8, "per_call": 4,
                    "sample": {"size": 4}}},
    "wfa.100_e5.cigar": {
        "traffic": {"pool": 64, "per_call": 16, "sample": {"size": 16}}},
}

# the control each cell's check is shown to fail: the 8-bit reference
# where scores pass 8 bits, the gap control where they cannot
CONTROL = {cell: "saturate8" for cell in SMALL}
CONTROL["wfa.100_e5.cigar"] = "gap"


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
