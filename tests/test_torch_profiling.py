"""The port's profiling hooks (``utils.profiling``) and dispatch's named
regions.

``trace_region`` records a ``record_function`` only while torch's
profiler is on and pushes an NVTX range only where CUDA is available;
``capture`` writes a Chrome trace in which every batch the port runs is
named ``pt.execute.<mode>.<outputs>``, as the reference names it.  The
``cuda`` test captures the card's kernels: ``python -m pytest
--noconftest -m cuda tests/test_torch_profiling.py``.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import parasail_rs_tpu_torch as port  # noqa: E402
from parasail_rs_tpu_torch.utils import profiling  # noqa: E402

PAIRS = ([b"HEAGAWGHEE", b"MKVLAT"], [b"PAWHEAE", b"MKVINLAT"])


def _sw(device):
    return (port.Aligner.new().matrix(port.Matrix.from_name("blosum62"))
            .gap_open(11).gap_extend(1).local().device(device).build())


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _no_nvtx(monkeypatch):
    """A torch without CUDA whose NVTX calls fail the test."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # regions read CUDA's availability once, on the first region after this
    monkeypatch.setattr(profiling, "_NVTX", None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", calls.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append("pop"))
    return calls


def test_trace_region_is_silent_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    calls = _no_nvtx(monkeypatch)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    with profiling.trace_region("pt.test.region"):
        x = torch.ones(4) + 1
    assert x.sum().item() == 8 and calls == []


def test_trace_region_is_named_under_the_profiler(monkeypatch):
    calls = _no_nvtx(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.trace_region("pt.test.region"):
            torch.ones(4) + 1
    assert "pt.test.region" in {e.key for e in prof.key_averages()}
    assert calls == []


def test_trace_region_pushes_nvtx_where_cuda_is(monkeypatch):
    calls = _no_nvtx(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with profiling.trace_region("pt.test.region"):
        assert calls == ["pt.test.region"]
    assert calls == ["pt.test.region", "pop"]
    with pytest.raises(ValueError):
        with profiling.trace_region("pt.test.raises"):
            raise ValueError
    assert calls[2:] == ["pt.test.raises", "pop"]


def test_capture_writes_a_chrome_trace_of_align_batch(tmp_path):
    aligner = _sw("cpu")
    log_dir = tmp_path / "traces"
    with profiling.capture(str(log_dir)) as prof:
        got = [a.get_score() for a in aligner.align_batch(*PAIRS)]
    assert got == [a.get_score() for a in aligner.align_batch(*PAIRS)]
    files = profiling.trace_files(str(log_dir))
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    named = [e for e in _events(files[0])
             if e.get("name") == "pt.execute.sw.score"]
    assert named and all(e["cat"] == "user_annotation" for e in named)
    assert "pt.execute.sw.score" in {e.key for e in prof.key_averages()}
    # a second capture adds a file of its own
    with profiling.capture(str(log_dir)):
        aligner.align(b"MKVLAT", b"MKVINLAT")
    assert len(profiling.trace_files(str(log_dir))) == 2


def test_segment_route_is_named(tmp_path, monkeypatch):
    from parasail_rs_tpu_torch.engine import dispatch

    monkeypatch.setattr(dispatch, "SEGMENT_MIN_CELLS", 16 * 16)
    aligner = (port.Aligner.new().gap_open(5).gap_extend(2).use_stats()
               .device("cpu").build())
    with profiling.capture(str(tmp_path)):
        aligner.align_batch([b"ACGT" * 10], [b"ACGA" * 12])
    assert aligner.route_counter == {("torch_segments", "long pairs"): 1}
    names = {e.get("name") for e in
             _events(profiling.trace_files(str(tmp_path))[0])}
    assert "pt.execute.nw.stats" in names


def test_start_server_raises():
    with pytest.raises(NotImplementedError, match="capture"):
        profiling.start_server(9999)


# -- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_capture_holds_a_kernel(cuda_device, tmp_path):
    aligner = _sw(cuda_device)
    aligner.align_batch(*PAIRS)
    with profiling.capture(str(tmp_path)):
        aligner.align_batch(*PAIRS)
        torch.cuda.synchronize()
    events = _events(profiling.trace_files(str(tmp_path))[0])
    assert any(e.get("cat") == "kernel" for e in events)
    assert any(e.get("name") == "pt.execute.sw.score" for e in events)
