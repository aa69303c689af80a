"""The port's CUDA kernels (multiagent_gnn_policies_tpu_torch/csrc/cells.cu)
against their plain PyTorch versions, on the card. Marked ``gpu``: it skips
without a card (a CUDA kernel has no CPU mode; the CPU tests cover the plain
versions against the JAX package). This file imports no JAX, so it also
runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerance: 1e-5 of each channel's largest magnitude (same float32
arithmetic, other summation order); degrees and min r^2 must be equal.
"""

import pytest
import torch

from multiagent_gnn_policies_tpu_torch.envs.flocking import (
    FlockingParams,
    _init_candidate,
)
from multiagent_gnn_policies_tpu_torch.ops import cells_cuda as tcc

REL = 1e-5


def _close(got, want, what, exact=()):
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape, what
    err = (got - want).abs().reshape(got.shape[0], -1).amax(0)
    scale = want.abs().reshape(want.shape[0], -1).amax(0).clamp_min(1e-30)
    assert (err <= REL * scale).all(), (what, err, scale)
    for q in exact:
        assert float(err[q]) == 0.0, (what, q, float(err[q]))


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    """Each CUDA kernel against its plain PyTorch version on the card, on a
    lattice swarm with an overflow-free grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    dev = torch.device("cuda")
    n = 4096
    tp = FlockingParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = _init_candidate(gen, tp, dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    assert int(grid.overflow) == 0
    for centralized in (True, False):
        got = tcc.frame_sweep(x, grid, ts, 1.0, centralized)
        want = tcc.frame_sweep_plain(x, grid, ts, 1.0, centralized)
        _close(got, want, "K1", exact=(6, 9))
    deg = want[:, 6].contiguous()
    cols = torch.randn((n, 12), generator=gen, device=dev)
    _close(tcc.apply_deg_sweep(x, cols, deg, grid, ts, 1.0),
           tcc.apply_deg_sweep_plain(x, cols, deg, grid, ts, 1.0), "K2")
    pos = x[:, :2].contiguous()
    wcols = cols[:, :6].contiguous()
    _close(tcc.apply_sweep(pos, wcols, grid, ts, 1.0),
           tcc.apply_sweep_plain(pos, wcols, grid, ts, 1.0), "K3")


@pytest.mark.gpu
def test_wrappers_raise_on_bad_cuda_input_and_count_launches():
    """For a CUDA tensor a wrapper launches its kernel or raises: it never
    takes the plain version. Only launches are counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode)")
    dev = torch.device("cuda")
    n = 512
    tp = FlockingParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    x = _init_candidate(torch.Generator(device=dev).manual_seed(1), tp, dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    tcc.reset_launch_counts()
    with pytest.raises(ValueError, match="dtype"):
        tcc.frame_sweep(x.double(), grid, ts, 1.0, True)
    with pytest.raises(ValueError, match="contiguous"):
        tcc.apply_sweep(x[:, :2], torch.ones((n, 6), device=dev), grid, ts,
                        1.0)
    with pytest.raises(ValueError, match="columns"):
        tcc.apply_sweep(x[:, :2].contiguous(),
                        torch.ones((n, 7), device=dev),
                        grid, ts, 1.0)
    assert set(tcc.launch_counts().values()) == {0}
    tcc.frame_sweep(x, grid, ts, 1.0, True)
    torch.cuda.synchronize()
    assert tcc.launch_counts()["frame_sweep"] == 1
