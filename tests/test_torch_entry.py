"""The port's entry points (``parasail_rs_tpu_torch/entry.py``) against
the JAX package's (``__graft_entry__.py``): the flagship forward step on
the same arrays, and the multi-process dry run over gloo."""

import numpy as np
import pytest
import torch

from parasail_rs_tpu_torch import entry


def test_entry_matches_the_graft_entry_wavefront():
    import __graft_entry__ as graft

    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    ref_fn, ref_args = graft.entry()
    # the same seed-0 arrays in the same order
    for a, b in zip(args, ref_args):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = ref_fn(*ref_args)
    for k in ("score", "end_query", "end_ref"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_dryrun_multichip_two_gloo_processes(capsys):
    import torch.distributed as td

    if not td.is_available() or not td.is_gloo_available():
        pytest.skip("needs torch.distributed with the gloo backend")
    entry.dryrun_multichip(2, device="cpu", timeout=240)
    assert "dryrun_multichip OK: 2 process(es) over gloo" in \
        capsys.readouterr().out


def test_default_device_raises_without_enough_cards():
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(have + 1)
    with pytest.raises(ValueError):
        entry.dryrun_multichip(0, device="cpu")


@pytest.mark.cuda
def test_entry_on_card_runs_the_short_form():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from parasail_rs_tpu_torch.ops import scan_kernel as tk

    fn, args = entry.entry()
    before = tk.SHORT_LAUNCHES["score"]
    got = fn(*args)
    assert tk.SHORT_LAUNCHES["score"] == before + 1
    cpu_fn, cpu_args = entry.entry(device="cpu")
    want = cpu_fn(*cpu_args)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
