"""The port's CUDA kernels (multiagent_gnn_policies_tpu_torch/csrc/cells.cu)
against their plain PyTorch versions, on the card. Marked ``gpu``: it skips
without a card (a CUDA kernel has no CPU mode; the CPU tests cover the plain
versions against the JAX package). This file imports no JAX, so it also
runs on a machine without JAX:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

Tolerance: 1e-5 of each channel's largest magnitude (same float32
arithmetic, other summation order); degrees and min r^2 must be equal, and
two launches on the same input bit-identical.
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


def _totals(by_cols):
    return {w: sum(by.values()) for w, by in by_cols.items()}


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
    _close(tcc.apply_sweep(pos, cols[:, 6:], deg, grid, ts, 1.0),
           tcc.apply_sweep_plain(pos, cols[:, 6:].contiguous(), deg, grid,
                                 ts, 1.0), "K3")


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
    ones = torch.ones(n, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tcc.apply_sweep(x[:, :2], torch.ones((n, 6), device=dev), ones,
                        grid, ts, 1.0)
    with pytest.raises(ValueError, match="columns"):
        tcc.apply_sweep(x[:, :2].contiguous(),
                        torch.ones((n, 7), device=dev), ones,
                        grid, ts, 1.0)
    cols = torch.ones((n * 12 + 1,), device=dev)[1:].view(n, 12)
    with pytest.raises(ValueError, match="aligned"):
        tcc.apply_deg_sweep(x, cols, torch.ones(n, device=dev), grid, ts,
                            1.0)
    assert set(tcc.launch_counts().values()) == {0}
    tcc.frame_sweep(x, grid, ts, 1.0, True)
    torch.cuda.synchronize()
    assert tcc.launch_counts()["frame_sweep"] == 1


def _swarm_on(dev, case):
    """(x (N, 4), spec, tile or None) of one hard case for the tile sweep."""
    gen = torch.Generator(device=dev).manual_seed(2)
    if case == "dense_chunks":
        # ~32 agents per cell of capacity 32 (many cells overflow); tiles
        # of 8 cells: a halo of ~960 agents takes two staging chunks and a
        # tile of ~256 agents two passes of the block's threads
        n, side = 2048, 16.0
        x = torch.rand((n, 4), generator=gen, device=dev) * side
        return x, tcc.PCellSpec(cx=8, cy=8, cap=32, cell=2.0), 8
    if case == "overflow":
        n = 1000
        x = torch.rand((n, 4), generator=gen, device=dev) * 6.0
        return x, tcc.make_pcell_spec(FlockingParams(n_agents=n), cap=8), None
    n = {"cap32_edge2": 4096, "ragged_n": 3001, "one_agent": 1}[case]
    tp = FlockingParams(n_agents=n)
    x = _init_candidate(gen, tp, dev)
    if case == "cap32_edge2":
        return x, tcc.make_pcell_spec(tp, cap=32, edge_mult=2.0), None
    return x, tcc.make_pcell_spec(tp), None


# the K2 and K3 widths of a K: K2's columns, and the columns of the (N, C2)
# array that K3 reads as a row-strided view
K_WIDTHS = {3: (12, slice(0, 6)), 4: (18, slice(6, 18))}


@pytest.mark.gpu
@pytest.mark.parametrize("k", sorted(K_WIDTHS))
@pytest.mark.parametrize("case", ["overflow", "cap32_edge2", "dense_chunks",
                                  "ragged_n", "one_agent"])
def test_kernels_match_plain_versions_on_hard_grids(case, k):
    """K1/K2/K3 against their plain versions where the tile sweep must
    loop or fill: dropped agents (overflow), cap 32 with edge_mult 2, a
    tile whose halo needs several staging chunks and whose agents several
    passes of the block, N not a multiple of the block, and N = 1; K2 and
    K3 at K = 3's widths (12 and 6 columns) and K = 4's (18 and 12). Two
    launches on one input are bit-identical, and at K = 4 each of K2 and
    K3 equals its 6-column slices launched alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    dev = torch.device("cuda")
    x, ts, tile = _swarm_on(dev, case)
    n = x.shape[0]
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    assert (int(grid.overflow) > 0) == (case in ("overflow", "dense_chunks"))
    if case == "dense_chunks":
        # one tile per grid row: its agents, and its halo of three rows
        row_n = torch.diff(grid.cell_start.cpu()[::ts.cy])
        assert int(row_n.max()) > tcc.BLOCK_THREADS
        assert int((row_n[:-2] + row_n[1:-1] + row_n[2:]).max()) > (
            max(tcc.FRAME_CHUNK, tcc.APPLY_DEG_CHUNK))
    c2, k3_cols = K_WIDTHS[k]
    gen = torch.Generator(device=dev).manual_seed(3)
    cols = torch.randn((n, c2), generator=gen, device=dev)
    view = cols[:, k3_cols]
    pos = x[:, :2].contiguous()
    runs = []
    for _ in range(2):
        per = tcc.frame_sweep(x, grid, ts, 1.0, True, tile=tile)
        deg = per[:, 6].contiguous()
        runs.append((per, tcc.apply_deg_sweep(x, cols, deg, grid, ts, 1.0,
                                              tile=tile),
                     tcc.apply_sweep(pos, view, deg, grid, ts, 1.0,
                                     tile=tile)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    per, applied, applied3 = runs[0]
    _close(per, tcc.frame_sweep_plain(x, grid, ts, 1.0, True), "K1",
           exact=(6, 9))
    _close(applied, tcc.apply_deg_sweep_plain(x, cols, per[:, 6], grid, ts,
                                              1.0), "K2")
    _close(applied3, tcc.apply_sweep_plain(x[:, :2], view, per[:, 6],
                                           grid, ts, 1.0), "K3")
    dropped = grid.slot < 0
    assert (per[dropped, :9] == 0).all() and (per[dropped, 9] == 1e12).all()
    assert (applied[dropped] == 0).all() and (applied3[dropped] == 0).all()
    if k == 4:
        assert torch.equal(applied, torch.cat(
            [tcc.apply_deg_sweep(x, cols[:, s:s + 6], deg, grid, ts, 1.0,
                                 tile=tile) for s in (0, 6, 12)], 1))
        assert torch.equal(applied3, torch.cat(
            [tcc.apply_sweep(pos, view[:, s:s + 6], deg, grid, ts, 1.0,
                             tile=tile) for s in (0, 6)], 1))


@pytest.mark.gpu
def test_k4_widths_are_bit_identical_across_launches_and_tiles():
    """On a lattice swarm at the cross-K transfer's radius of 1.5 (its
    cells hold ~2 agents): K2 at 18 columns and K3 at 12 on the delayed
    stack's row-strided view give the same bits in two launches at the
    default tile and at tiles of 1 and 3 columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    dev = torch.device("cuda")
    n = 4096
    tp = FlockingParams(n_agents=n, comm_radius=1.5)
    ts = tcc.make_pcell_spec(tp)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _init_candidate(gen, tp, dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    assert int(grid.overflow) == 0
    deg = tcc.frame_sweep(x, grid, ts, 2.25, True)[:, 6].contiguous()
    cols = torch.randn((n, 18), generator=gen, device=dev)
    pos = x[:, :2].contiguous()
    for run in (lambda t: tcc.apply_deg_sweep(x, cols, deg, grid, ts, 2.25,
                                              tile=t),
                lambda t: tcc.apply_sweep(pos, cols[:, 6:], deg, grid, ts,
                                          2.25, tile=t)):
        outs = [run(t) for t in (None, None, 1, 3)]
        torch.cuda.synchronize()
        assert all(torch.equal(outs[0], o) for o in outs[1:])
        assert outs[0].abs().sum() > 0


def _delayed_stack_case(dev, c):
    """K3's inputs as the delayed stack hands them over at K = 3 (c = 6):
    an earlier frame's positions, grid and degrees, and the columns as a
    row-strided view of the (N, 2c) pre-applied output, 24 bytes in (for
    c = 12 a view of an (N, 24) array, 48 bytes in)."""
    n = 4096
    tp = FlockingParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = _init_candidate(gen, tp, dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    deg = tcc.frame_sweep(x, grid, ts, 1.0, True)[:, 6].contiguous()
    s0 = torch.randn((n, 2 * c), generator=gen, device=dev)
    cols = s0.reshape(n, 2, c).transpose(0, 1)[1:].transpose(0, 1).reshape(
        n, c)
    assert cols.stride() == (2 * c, 1) and not cols.is_contiguous()
    return x[:, :2].contiguous(), cols, deg, grid, ts


@pytest.mark.gpu
@pytest.mark.parametrize("c", [6, 12])
def test_historical_apply_reads_the_delayed_stacks_strided_columns(c):
    """K3 on the row-strided view the delayed stack passes (C = 6 on the
    main path; C = 12 is built for K2's column counts and launched here),
    against the plain version on a contiguous copy, at the default tile and
    at one column per tile; launches on one input are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    dev = torch.device("cuda")
    pos, cols, deg, grid, ts = _delayed_stack_case(dev, c)
    want = tcc.apply_sweep_plain(pos, cols.contiguous(), deg, grid, ts, 1.0)
    runs = [tcc.apply_sweep(pos, cols, deg, grid, ts, 1.0, tile=t)
            for t in (None, None, 1)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    _close(runs[0], want, f"K3 C={c}")
    # the same sums as dividing first and adding the quotients: what K3
    # computed before it took the division in (and the JAX package does)
    assert torch.equal(runs[0], tcc.apply_sweep(
        pos, cols / deg.clamp_min(1.0)[:, None], torch.ones_like(deg), grid,
        ts, 1.0))


@pytest.mark.gpu
def test_historical_apply_refuses_columns_it_cannot_read_in_place():
    """K3 reads columns whose rows are contiguous and 8-byte aligned; any
    other view raises before a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the checks guard a CUDA launch)")
    dev = torch.device("cuda")
    pos, cols, deg, grid, ts = _delayed_stack_case(dev, 6)
    n = pos.shape[0]
    tcc.reset_launch_counts()
    flat = torch.ones((n * 12 + 1,), device=dev)
    for match, view in (
            ("stride", flat[:6 * n].view(6, n).t()),       # column-major
            ("aligned", flat[1:].view(n, 12)[:, :6]),      # 4 bytes in
            ("aligned", flat[:7 * n].view(n, 7)[:, :6])):  # odd row stride
        with pytest.raises(ValueError, match=match):
            tcc.apply_sweep(pos, view, deg, grid, ts, 1.0)
    with pytest.raises(ValueError, match="deg"):
        tcc.apply_sweep(pos, cols, deg[:-1], grid, ts, 1.0)
    assert tcc.launch_counts()["apply_sweep"] == 0


@pytest.mark.gpu
def test_grid_build_never_waits_for_the_device():
    """build_pcell_grid issues no operation that synchronises the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the host-sync check is CUDA's)")
    dev = torch.device("cuda")
    tp = FlockingParams(n_agents=4096)
    x = _init_candidate(torch.Generator(device=dev).manual_seed(4), tp, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grid = tcc.build_pcell_grid(x[:, :2], tcc.make_pcell_spec(tp))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(grid.cell_start[-1]) == 4096 - int(grid.overflow)
    assert torch.equal(grid.kept.sort().values,
                       torch.arange(4096, dtype=torch.int32, device=dev))


@pytest.mark.gpu
def test_grid_on_the_card_equals_the_grid_on_the_cpu():
    """The CUDA sorts give the CPU's grid, drops included: an overflowing
    swarm with agents outside the grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gen = torch.Generator().manual_seed(6)
    pos = torch.rand((3000, 2), generator=gen) * 5.0
    pos[::97] += 100.0                      # outside the grid, clamped
    ts = tcc.make_pcell_spec(FlockingParams(n_agents=3000), cap=8)
    want = tcc.build_pcell_grid(pos, ts)
    got = tcc.build_pcell_grid(pos.cuda(), ts)
    assert int(want.overflow) > 0
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a.cpu(), b), name


@pytest.mark.gpu
def test_tile_timeline_reads_every_phase(capsys):
    """ops/tile_timeline.py builds the stamped library and reports each
    phase of K1's tile sweep and of K2's and K3's at every width it builds
    (its default ``--cols``), each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from multiagent_gnn_policies_tpu_torch.ops import tile_timeline

    tile_timeline.main(["--n", "4096"])
    out = capsys.readouterr().out
    kernels = ["K1 frame_kernel: "]
    for c in tcc.APPLY_COLS:
        kernels += [f"K2 apply_deg_kernel C={c}: ",
                    f"K3 apply_kernel C={c}, row stride {c + 6}: "]
    for name in kernels:
        assert out.count(name) == 1, name
    for label, _, _ in tile_timeline.PHASES:
        assert out.count(label) == len(kernels), label


def _transfer_case(dev):
    """K2's and K3's inputs at K = 4 as the delayed stack hands them over:
    the new frame's degrees and (N, 18) s = 0 columns; an earlier frame's
    positions, grid and degrees with the (N, 12) row-strided view of the
    pre-applied (N, 18) output, 24 bytes in."""
    n = 4096
    tp = FlockingParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = _init_candidate(gen, tp, dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    deg = tcc.frame_sweep(x, grid, ts, 1.0, True)[:, 6].contiguous()
    cols = torch.randn((n, 18), generator=gen, device=dev)
    view = cols.reshape(n, 3, 6)[:, 1:].reshape(n, 12)
    assert view.stride() == (18, 1)
    return x, cols, view, deg, grid, ts


@pytest.mark.gpu
def test_new_widths_match_plain_versions():
    """K2 at 18 columns (8-byte row loads) and K3 at 12 on the row-strided
    view, each one launch, against the plain versions; K2 at 12 on a view
    (8-byte loads) equals K2 at 12 on a contiguous copy (16-byte loads) bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; the CPU tests cover their plain versions)")
    dev = torch.device("cuda")
    x, cols, view, deg, grid, ts = _transfer_case(dev)
    pos = x[:, :2].contiguous()
    tcc.reset_launch_counts()
    k2 = tcc.apply_deg_sweep(x, cols, deg, grid, ts, 1.0)
    k3 = tcc.apply_sweep(pos, view, deg, grid, ts, 1.0)
    k2v = tcc.apply_deg_sweep(x, view, deg, grid, ts, 1.0)
    k2c = tcc.apply_deg_sweep(x, view.contiguous(), deg, grid, ts, 1.0)
    torch.cuda.synchronize()
    assert tcc.launch_counts_by_cols()["apply_deg_sweep"] == {12: 2, 18: 1}
    assert tcc.launch_counts_by_cols()["apply_sweep"] == {12: 1}
    _close(k2, tcc.apply_deg_sweep_plain(x, cols, deg, grid, ts, 1.0),
           "K2 C=18")
    _close(k3, tcc.apply_sweep_plain(pos, view.contiguous(), deg, grid, ts,
                                     1.0), "K3 C=12")
    assert torch.equal(k2v, k2c)


@pytest.mark.gpu
def test_wide_columns_launch_in_counted_chunks():
    """24 columns go as chunks of 18 and 6, two launches counted, each
    chunk read in place; the result equals the plain version's and the
    chunks launched alone. A column count that is not whole 6-column
    slots raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    dev = torch.device("cuda")
    x, _, _, deg, grid, ts = _transfer_case(dev)
    n = x.shape[0]
    pos = x[:, :2].contiguous()
    cols = torch.randn((n, 30), generator=torch.Generator(
        device=dev).manual_seed(12), device=dev)[:, 6:]     # (N, 24), view
    tcc.reset_launch_counts()
    k2 = tcc.apply_deg_sweep(x, cols, deg, grid, ts, 1.0)
    k3 = tcc.apply_sweep(pos, cols, deg, grid, ts, 1.0)
    torch.cuda.synchronize()
    assert tcc.launch_counts() == {"frame_sweep": 0, "apply_deg_sweep": 2,
                                   "apply_sweep": 2}
    assert tcc.launch_counts_by_cols()["apply_sweep"] == {6: 1, 18: 1}
    _close(k2, tcc.apply_deg_sweep_plain(x, cols, deg, grid, ts, 1.0),
           "K2 C=24")
    _close(k3, tcc.apply_sweep_plain(pos, cols, deg, grid, ts, 1.0),
           "K3 C=24")
    assert torch.equal(k2[:, 18:], tcc.apply_deg_sweep(
        x, cols[:, 18:], deg, grid, ts, 1.0))
    assert torch.equal(k3[:, :18], tcc.apply_sweep(
        pos, cols[:, :18].contiguous(), deg, grid, ts, 1.0))
    tcc.reset_launch_counts()
    for c in (7, 20, 3):
        with pytest.raises(ValueError, match="columns"):
            tcc.apply_deg_sweep(x, torch.ones((n, c), device=dev), deg,
                                grid, ts, 1.0)
        with pytest.raises(ValueError, match="columns"):
            tcc.apply_sweep(pos, torch.ones((n, c), device=dev), deg, grid,
                            ts, 1.0)
    assert set(tcc.launch_counts().values()) == {0}


def _ddpg_cfg(gn, n):
    from multiagent_gnn_policies_tpu_torch.algos.ddpg import DDPGConfig
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig
    from multiagent_gnn_policies_tpu_torch.models.critic import CriticConfig

    hidden = (16, 16)
    return DDPGConfig(
        actor=ActorConfig(6, 2, hidden, 2, ind_agg=1, bound="tanh"),
        critic=CriticConfig(6, 2, hidden, 2, use_groupnorm=gn,
                            input_transform="identity" if gn else "asinh"),
        env_name="FlockingRelative-v0",
        env=FlockingParams(n_agents=n, episode_steps=20),
        batch_size=8, buffer_size=64, actor_lr=1e-4, critic_lr=1e-3,
        tau=0.1, seed=0)


def _ddpg_batch(large, n, b=8, k=2):
    from multiagent_gnn_policies_tpu_torch.algos.ddpg_large import (
        dense_adj_from_pos,
    )

    gen = torch.Generator().manual_seed(1)
    pos = 2.0 * torch.rand(b, k, n, 2, generator=gen) - 1.0
    nxt = 2.0 * torch.rand(b, n, 2, generator=gen) - 1.0
    batch = {"next_values": torch.randn(b, n, 6, generator=gen),
             "action": 2.0 * torch.rand(b, n, 2, generator=gen) - 1.0,
             "reward": -5.0 + torch.randn(b, generator=gen),
             "notdone": torch.ones(b)}
    hist = torch.randn(b, k, n, 6, generator=gen)
    if large:
        return {**batch, "hist": hist, "pos": pos[:, :k - 1],
                "next_pos": nxt}
    adj = dense_adj_from_pos(pos, 1.0)
    gso = torch.stack([torch.eye(n).expand(b, n, n), adj[:, 0]], 1)
    return {**batch, "delay_state": hist, "delay_gso": gso,
            "network": adj[:, 0], "next_network": dense_adj_from_pos(nxt, 1.0)}


@pytest.mark.gpu
@pytest.mark.parametrize("large", [False, True], ids=["dense", "large"])
def test_ddpg_gradient_step_card_vs_cpu(large):
    """One DDPG gradient step (dense with GroupNorm; positions-record
    without) from the same networks on the same batch, on the card and on
    the CPU: both losses and every updated network, target and Adam
    moment within 1e-4 of its largest magnitude. With GroupNorm a hidden
    critic layer's bias has a zero gradient up to rounding (the
    normalisation subtracts it) and Adam turns that noise into a step of
    up to (1 - beta1) / sqrt(1 - beta2) · lr: such a bias is held to twice
    that and its moments are not held."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (card against CPU)")
    from multiagent_gnn_policies_tpu_torch.algos.ddpg import DDPG
    from multiagent_gnn_policies_tpu_torch.algos.ddpg_large import DDPGLarge

    n = 512 if large else 24
    cfg = _ddpg_cfg(gn=not large, n=n)
    cls = DDPGLarge if large else DDPG
    cpu = cls(cfg, device="cpu")
    card = cls(cfg, device="cuda")
    for name, m in cpu._modules().items():
        getattr(card, name).load_state_dict(m.state_dict())
    batch = _ddpg_batch(large, n)
    want = cpu.gradient_step(batch)
    got = card.gradient_step({k: v.cuda() for k, v in batch.items()})
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-4 * max(abs(float(w)), 1.0)
    free = {i for i, (name, _) in enumerate(cpu.critic.named_parameters())
            if name.endswith("bias") and name.startswith("layers.")
            and int(name.split(".")[1]) < cfg.critic.n_layers - 1
            and cfg.critic.use_groupnorm}
    for mod in ("actor", "actor_target", "critic", "critic_target"):
        for i, (w, g) in enumerate(zip(getattr(cpu, mod).parameters(),
                                       getattr(card, mod).parameters())):
            err = float((g.detach().cpu() - w.detach()).abs().max())
            if mod.startswith("critic") and i in free:
                adam_step_max = (1 - 0.9) / (1 - 0.999) ** 0.5
                assert err <= 2 * adam_step_max * cfg.critic_lr, (mod, i)
            else:
                assert err <= 1e-4 * float(w.detach().abs().max()), (mod, i)
    for net in ("actor", "critic"):
        w_st = getattr(cpu, f"{net}_opt").state
        g_st = getattr(card, f"{net}_opt").state
        for i, (wp, gp) in enumerate(zip(getattr(cpu, net).parameters(),
                                         getattr(card, net).parameters())):
            if net == "critic" and i in free:
                continue
            for key in ("exp_avg", "exp_avg_sq"):
                w, g = w_st[wp][key], g_st[gp][key].cpu()
                assert float((g - w).abs().max()) <= 1e-4 * float(
                    w.abs().max()), (net, i, key)


@pytest.mark.gpu
def test_verify_cells_quick_passes_on_gpu(capsys):
    """The cell-sweep gate with ``--quick`` (N = 2,048 and 12,288, the 1M
    geometry, the rollouts) prints no ``[FAIL]`` and exits 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the gate times and checks the "
                    "kernels)")
    from multiagent_gnn_policies_tpu_torch.scripts import verify_cells

    assert verify_cells.main(["--quick"]) == 0
    out = capsys.readouterr().out
    assert "[FAIL]" not in out and "ALL PASSED" in out


@pytest.mark.gpu
def test_blocked_path_launches_no_cell_kernel():
    """A blocked-path episode on the card launches none of K1-K3 and
    reports overflow 0; the same episode on the pcells path launches
    K1 T+1 times and K2 and K3 T times, and the two agree within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (kernel launch counters)")
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    steps = 10
    p = FlockingParams(n_agents=2048, episode_steps=steps)
    acfg, actor = seeded_actor(3, 0, dev)
    x0 = _init_candidate(torch.Generator(device=dev).manual_seed(2), p, dev)
    out = {}
    for path in ("blocked", "pcells"):
        run = lambda: tln.rollout_large(actor, acfg, None, p, x0=x0,
                                        return_overflow=True, path=path)
        with torch.no_grad():
            run()         # pcells: the episode program's capture
            tcc.reset_launch_counts()
            (r, _, ovf), launched = tcc.device_launches(run)
        out[path] = (r, int(ovf), _totals(launched))
        if path == "blocked":
            assert set(tcc.launch_counts().values()) == {0}
    assert out["blocked"][1:] == (0, {"frame_sweep": 0, "apply_deg_sweep": 0,
                                      "apply_sweep": 0})
    assert out["pcells"][1:] == (0, {"frame_sweep": steps + 1,
                                     "apply_deg_sweep": steps,
                                     "apply_sweep": steps})
    rb, rp = out["blocked"][0].double(), out["pcells"][0].double()
    assert float((rb - rp).abs().max()) <= 1e-4 * float(rp.abs().max())


def _band_case(dev):
    """A perturbed lattice at N = 4,096 on a grid whose rows split into 2,
    3 and 4 bands (``n_dev = 12``), its degrees and columns."""
    n = 4096
    tp = FlockingParams(n_agents=n)
    ts = tcc.make_pcell_spec(tp, n_dev=12)
    gen = torch.Generator(device=dev).manual_seed(21)
    x = _init_candidate(gen, tp, dev)
    x[:, :2] += 0.05 * torch.randn((n, 2), generator=gen, device=dev)
    grid = tcc.build_pcell_grid(x[:, :2], ts)
    assert int(grid.overflow) == 0
    deg = tcc.frame_sweep(x, grid, ts, 1.0, True)[:, 6].contiguous()
    cols = torch.randn((n, 18), generator=gen, device=dev)
    return x, ts, grid, deg, cols


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 3, 4])
def test_bands_sum_to_the_full_launch_on_gpu(d):
    """K1, K2 (12 and 18 columns) and K3 (6 and 12, the 12 a row-strided
    view) over the D bands of the grid rows: each band holds against its
    plain band version, writes 0 outside the band, and the bands' sum is
    the full launch bit for bit. D = 3 gives bands of an odd row count,
    whose last tile row lies past the band."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (the kernels have no CPU "
                    "mode; tests/test_torch_sharding.py covers the plain "
                    "bands)")
    dev = torch.device("cuda")
    x, ts, grid, deg, cols = _band_case(dev)
    pos = x[:, :2].contiguous()
    sweeps = {
        "K1": (lambda b: tcc.frame_sweep(x, grid, ts, 1.0, True, band=b),
               lambda b: tcc.frame_sweep_plain(x, grid, ts, 1.0, True,
                                               band=b), (6, 9)),
        "K2 C=12": (lambda b: tcc.apply_deg_sweep(
            x, cols[:, :12].contiguous(), deg, grid, ts, 1.0, band=b),
            lambda b: tcc.apply_deg_sweep_plain(
                x, cols[:, :12], deg, grid, ts, 1.0, band=b), ()),
        "K2 C=18": (lambda b: tcc.apply_deg_sweep(x, cols, deg, grid, ts,
                                                  1.0, band=b),
                    lambda b: tcc.apply_deg_sweep_plain(
                        x, cols, deg, grid, ts, 1.0, band=b), ()),
        "K3 C=6": (lambda b: tcc.apply_sweep(
            pos, cols[:, :6].contiguous(), deg, grid, ts, 1.0, band=b),
            lambda b: tcc.apply_sweep_plain(
                pos, cols[:, :6], deg, grid, ts, 1.0, band=b), ()),
        "K3 C=12": (lambda b: tcc.apply_sweep(pos, cols[:, 6:], deg, grid,
                                              ts, 1.0, band=b),
                    lambda b: tcc.apply_sweep_plain(
                        pos, cols[:, 6:].contiguous(), deg, grid, ts, 1.0,
                        band=b), ()),
    }
    for name, (kernel, plain, exact) in sweeps.items():
        full = kernel(None)
        total = torch.zeros_like(full)
        for r in range(d):
            band = tcc.row_band(ts, d, r)
            out = kernel(band)
            own = tcc.band_agents(grid, ts, band)
            assert not out[~own].any(), (name, band)
            _close(out, plain(band), f"{name} band {band}", exact=exact)
            total += out
        torch.cuda.synchronize()
        assert torch.equal(total, full), name


@pytest.mark.gpu
def test_bad_band_raises_on_gpu():
    """A band outside the grid, or of no rows, raises in the wrapper before
    any launch, and the C launcher refuses it too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from multiagent_gnn_policies_tpu_torch.ops import _build

    dev = torch.device("cuda")
    x, ts, grid, deg, cols = _band_case(dev)
    tcc.reset_launch_counts()
    for band in [(ts.cx - 1, 2), (-1, 3), (0, 0), (ts.cx, 1)]:
        with pytest.raises(ValueError, match="band of grid rows"):
            tcc.frame_sweep(x, grid, ts, 1.0, True, band=band)
        with pytest.raises(ValueError, match="band of grid rows"):
            tcc.apply_sweep(x[:, :2].contiguous(), cols[:, :6].contiguous(),
                            deg, grid, ts, 1.0, band=band)
    assert set(tcc.launch_counts().values()) == {0}
    out = torch.zeros((x.shape[0], 10), device=dev)
    lib = _build.library()
    stream = torch.cuda.current_stream().cuda_stream
    for row0, rows in [(ts.cx - 1, 2), (-1, 3), (0, 0)]:
        rc = lib.cells_frame(x.data_ptr(), grid.kept.data_ptr(),
                             grid.cell_start.data_ptr(), out.data_ptr(),
                             x.shape[0], ts.cx, ts.cy, row0, rows, 8, 1.0, 1,
                             stream)
        assert rc != 0, (row0, rows)
    torch.cuda.synchronize()
    assert not out.any()


@pytest.mark.gpu
def test_world_of_one_nccl_mesh_on_gpu():
    """The port's multihost demo as a one-rank NCCL group on the card: the
    all_reduce, and the agent-sharded expert rollout (the sharded grid
    build, the banded sweeps' completions) equal to the same rollout with
    no group, bit for bit. A subprocess, so that no process group is left
    in this one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL)")
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m",
         "multiagent_gnn_policies_tpu_torch.scripts.multihost_demo",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
         "--process-id", "0", "--n-agents", "32768"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "MULTIHOST_OK rank=0/1 devices=1 psum=1.0" in proc.stdout


@pytest.mark.gpu
def test_trace_events_summarize_as_the_event_list_on_gpu():
    """``utils/profiling.trace_events`` (the raw kineto events) gives
    ``summarize_trace`` the device operations, busy time and layer ranges
    that ``prof.events()`` gives it, on a trace with host and device
    activity."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (device events)")
    from torch.profiler import ProfilerActivity, profile, record_function

    from multiagent_gnn_policies_tpu_torch.utils.profiling import (
        summarize_trace, trace_events)

    x = torch.randn(4096, 64, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with record_function("layer: product"):
                y = x @ x.t()
            y.sum()
        torch.cuda.synchronize()
    want = summarize_trace(prof.events(), 5, 1.0, 1.0)
    got = summarize_trace(trace_events(prof), 5, 1.0, 1.0)
    assert got["ops_per_step"] == want["ops_per_step"] > 0
    assert {k: n for k, (_, n) in got["by_name"].items()} == {
        k: n for k, (_, n) in want["by_name"].items()}
    assert abs(got["busy_ms"] - want["busy_ms"]) <= 1e-3 * want["busy_ms"]


# --- the episode program: the episode as a CUDA graph ----------------------

GRAPH_N, GRAPH_T = 4096, 13   # 13 steps: chunks of 4 or 3 end shorter


def _graph_case(case):
    """``(params, rollout_large keywords, K)`` of a graph-against-eager
    case at N = 4,096 (the lattice regime: the reset never waits for the
    device)."""
    from multiagent_gnn_policies_tpu_torch.envs.flocking import ENV_REGISTRY

    env = "FlockingStochastic-v0" if case == "stochastic" else \
        "FlockingRelative-v0"
    p = ENV_REGISTRY[env](FlockingParams(n_agents=GRAPH_N,
                                         episode_steps=GRAPH_T))
    kw = {"k1": ({}, 1), "k2": ({}, 2), "k3": ({}, 3), "k4": ({}, 4),
          "expert": (dict(expert_mode=True), 3), "stochastic": ({}, 3),
          "n_episodes": (dict(n_episodes=3), 3),
          "scan_chunks": (dict(scan_chunks=4), 3),
          "traj_agents": (dict(traj_agents=64, scan_chunks=5), 4),
          "expert_chunks": (dict(expert_mode=True, scan_chunks=3), 3)}[case]
    return p, kw[0], kw[1]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k1", "k2", "k3", "k4", "expert",
                                  "stochastic", "n_episodes", "scan_chunks",
                                  "traj_agents", "expert_chunks"])
def test_graph_episode_equals_the_eager_loop_on_gpu(case):
    """``rollout_large`` through its episode program (a CUDA graph) against
    the eager loop (``graph=False``) on the same generator: every output
    bit for bit, the generator left in the same state (the stochastic
    variant draws its noise inside the graph). The replay launches on the
    device what the eager loop launches (profiler traces), and its
    wrappers count only the resets' K1: the replay calls none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p, kw, k = _graph_case(case)
    acfg, actor = seeded_actor(k, 0, dev)
    tln.clear_programs()
    out, host, device, states = [], [], [], []
    for graph in (False, True, True):      # eager, capture, replay
        gen = torch.Generator(device=dev).manual_seed(5)
        tcc.reset_launch_counts()
        res, launched = tcc.device_launches(lambda: tln.rollout_large(
            actor, acfg, gen, p, device=dev, return_overflow=True,
            graph=graph, **kw))
        out.append(res)
        host.append(tcc.launch_counts_by_cols())
        device.append(launched)
        states.append(gen.get_state())
    for graphed in out[1:]:
        for a, b in zip(out[0], graphed, strict=True):
            assert torch.equal(a, b), case
    assert int(out[2][2]) == 0
    assert device[2] == device[0], (device[0], device[2])
    assert device[0] == host[0]
    resets = kw.get("n_episodes", 1)
    assert host[2] == {"frame_sweep": {10: resets}, "apply_deg_sweep": {},
                       "apply_sweep": {}}, host[2]
    assert torch.equal(states[0], states[1])
    assert torch.equal(states[0], states[2])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["cloning", "dagger"])
def test_graph_collection_equals_the_eager_loop_on_gpu(mode):
    """The large learner's collection episode through its program against
    the eager loop on the same generator (the reset, coins and subsample
    drawn before the episode, the stochastic variant's noise inside it):
    records, reward and overflow bit for bit, K1 T+1 and K2 and K3 T
    launches on the device each (profiler traces), the generator left
    where the loop leaves it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
    from multiagent_gnn_policies_tpu_torch.envs.flocking import ENV_REGISTRY
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p = ENV_REGISTRY["FlockingStochastic-v0"](
        FlockingParams(n_agents=GRAPH_N, episode_steps=GRAPH_T))
    cfg = tln.make_config(p, need_expert=True)
    acfg, actor = seeded_actor(3, 0, dev)
    out = {}
    for graph in (False, True, True):      # eager, capture, replay
        gen = torch.Generator(device=dev).manual_seed(8)
        (samples, r, ovf), launched = tcc.device_launches(
            lambda: til.collect_episode(cfg, actor, acfg, mode, 256, gen,
                                        0.5, dev, graph=graph))
        out[graph] = (samples, r, ovf, _totals(launched), gen.get_state())
    (sa, ra, oa, la, ga), (sb, rb, ob, lb, gb) = out[False], out[True]
    assert all(torch.equal(sa[key], sb[key]) for key in ("agg", "act"))
    assert torch.equal(ra, rb) and int(oa) == int(ob) == 0
    assert la == lb == {"frame_sweep": GRAPH_T + 1,
                        "apply_deg_sweep": GRAPH_T,
                        "apply_sweep": GRAPH_T}
    assert torch.equal(ga, gb)


@pytest.mark.gpu
def test_graph_replay_never_waits_for_the_device():
    """Once captured, an episode through the program (the eager reset in
    the lattice regime, the copies into the static buffers, the replay,
    the generator's state moved in and out) issues no operation that
    synchronises the host; the capture itself ran under the same mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the host-sync check is CUDA's)")
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p, kw, k = _graph_case("stochastic")
    acfg, actor = seeded_actor(k, 0, dev)
    tln.clear_programs()
    outs = []
    for _ in range(2):        # the first call captures, the second replays
        gen = torch.Generator(device=dev).manual_seed(2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(tln.rollout_large(actor, acfg, gen, p, device=dev,
                                          return_overflow=True, graph=True))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.gpu
def test_graph_reads_the_callers_weights_on_gpu():
    """The program copies the caller's parameters before each replay: an
    in-place change of the actor's weights (as Adam makes them) and a
    second actor of the same widths both reach the replay, and each
    episode equals the eager loop with those weights; an actor of other
    widths raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p = FlockingParams(n_agents=GRAPH_N, episode_steps=GRAPH_T)
    acfg, actor = seeded_actor(3, 0, dev)
    _, other = seeded_actor(3, 1, dev)

    def both(a):
        x0 = _init_candidate(torch.Generator(device=dev).manual_seed(3), p,
                             dev)
        return [tln.rollout_large(a, acfg, None, p, x0=x0, device=dev,
                                  graph=g)[0] for g in (False, True)]

    first = both(actor)
    with torch.no_grad():
        for w in actor.parameters():
            w.mul_(0.5)
    halved = both(actor)
    second = both(other)
    for eager, graphed in (first, halved, second):
        assert torch.equal(eager, graphed)
    assert not torch.equal(first[1], halved[1])
    assert not torch.equal(first[1], second[1])
    _, wide = seeded_actor(3, 0, dev, hidden=(16, 16))
    with pytest.raises(ValueError, match="widths"):
        tln.rollout_large(wide, acfg, None, p, x0=torch.zeros(GRAPH_N, 4,
                                                              device=dev),
                          device=dev, graph=True)


# --- the compiled imitation round: the update and dense episode programs ---

def _round_cfg(large, seed=3, **kw):
    """A small DAGGER learner's config: dense at N = 512 (the lattice
    regime: its reset never waits for the device) or large-N at N =
    4,096, S = 256, both of the canonical widths."""
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
    from multiagent_gnn_policies_tpu_torch.models.actor import ActorConfig

    d = dict(mode="dagger", actor=ActorConfig(n_s=6, n_a=2, hidden=(32, 32),
                                              k=3),
             env_name="FlockingStochastic-v0", batch_size=8, buffer_size=64,
             updates_per_episode=6, actor_lr=1e-3, n_train_episodes=6,
             test_interval=4, n_test_episodes=2, seed=seed)
    d.update(kw)
    if large:
        return til.LargeNImitationConfig(
            env=FlockingParams(n_agents=GRAPH_N, episode_steps=GRAPH_T),
            store_agents=256, **d)
    return tim.ImitationConfig(
        env=FlockingParams(n_agents=512, episode_steps=GRAPH_T), **d)


def _learner(large, graph=None, **kw):
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til

    cls = til.LargeNImitationLearner if large else tim.ImitationLearner
    return cls(_round_cfg(large, **kw), device="cuda", graph=graph)


def _learner_state(lrn):
    """A learner's whole training state, flattened, on the host."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            else:
                out[f"{path}/{k}"] = (v.detach().cpu() if isinstance(
                    v, torch.Tensor) else torch.as_tensor(v))
    walk(lrn.training_state(), "")
    return out


def _same_learners(a, b):
    sa, sb = _learner_state(a), _learner_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("large", [False, True], ids=["dense", "large"])
def test_update_program_equals_the_eager_loop_on_gpu(large):
    """``n`` Adam updates through the update program (a CUDA graph
    replayed per update) against the loop of ``adam_update`` on the same
    learner state, at the dense (K, N, F) and the subsampled (K, S, F)
    record: parameters, Adam's state, the loss sum and the generator bit
    for bit; and the capturable Adam the learners build on the card
    against the Adam without it (the optimizer before the programs,
    whose bias correction is computed on the host) on the same batches,
    within 1e-6 of each tensor's largest magnitude (the tolerance
    ``tests/test_torch_imitation.py`` holds Adam to against
    optax.adam)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    import copy

    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim

    lrns = [_learner(large, graph) for graph in (None, False)]
    record = lrns[0]._example_record()
    fill = torch.Generator(device="cuda").manual_seed(1)
    for lrn in lrns:
        fill.manual_seed(1)
        lrn.buffer.insert({k: torch.randn((40, *v.shape), generator=fill,
                                          device="cuda")
                           for k, v in record.items()})
    prog, eager = lrns
    host_actor = copy.deepcopy(eager.actor)
    host_opt = torch.optim.Adam(host_actor.parameters(), lr=1e-3)
    assert eager.opt.defaults["capturable"] and not host_opt.defaults[
        "capturable"]
    n, b = 7, prog.cfg.batch_size
    for rnd in range(2):     # the first run captures, the second replays
        draws = torch.Generator(device="cuda")
        draws.set_state(eager.gen.get_state())
        batches = [eager.buffer.sample(draws, b) for _ in range(n)]
        got = prog._updates.run(n, prog.gen)
        want = torch.zeros((), device="cuda")
        for _ in range(n):
            want += tim.adam_update(eager.actor, eager.opt,
                                    eager.buffer.sample(eager.gen, b))
        assert torch.equal(got, want), rnd
        _same_learners(prog, eager)
        for batch in batches:
            tim.adam_update(host_actor, host_opt, batch)
    for g, w in zip(prog.actor.parameters(), host_actor.parameters()):
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("mode,env,centralized", [
    ("dagger", "FlockingRelative-v0", True),
    ("cloning", "FlockingRelative-v0", True),
    ("eval", "FlockingRelative-v0", True),
    ("expert", "FlockingRelative-v0", True),
    ("expert", "FlockingRelative-v0", False),
    ("dagger", "FlockingStochastic-v0", True),
    ("eval", "FlockingStochastic-v0", True),
], ids=["dagger", "cloning", "eval", "baseline", "baseline_decentralized",
        "stochastic_dagger", "stochastic_eval"])
def test_dense_program_equals_the_eager_loop_on_gpu(mode, env, centralized):
    """``rollout_episode`` at N = 100 through its dense episode program (a
    CUDA graph: a capture, then a replay) against the eager loop
    (``graph=False``) from the same generator: records, rewards and the
    generator's state after the episode bit for bit (the stochastic
    variant draws its noise inside the graph)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.envs.flocking import make_env
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    acfg, actor = seeded_actor(3, 0, dev)
    e = make_env(env, FlockingParams(n_agents=100, episode_steps=GRAPH_T))
    collect = mode in ("dagger", "cloning")
    tim.dense_program.cache_clear()
    out = []
    for graph in (False, True, True):      # eager, capture, replay
        gen = torch.Generator(device=dev).manual_seed(4)
        res = tim.rollout_episode(actor, gen, 0.5, e, acfg, mode=mode,
                                  collect=collect, n_envs=4,
                                  centralized=centralized, graph=graph)
        res = res if collect else ({}, res)
        out.append((res, gen.get_state()))
    (want, want_gen) = out[0]
    for got, got_gen in out[1:]:
        assert all(torch.equal(got[0][k], want[0][k]) for k in want[0])
        assert torch.equal(got[1], want[1]) and bool(
            torch.isfinite(got[1]).all())
        assert torch.equal(got_gen, want_gen)


@pytest.mark.gpu
@pytest.mark.parametrize("large", [False, True], ids=["dense", "large"])
def test_program_rounds_equal_eager_rounds_on_gpu(large):
    """Three DAGGER rounds (the first with its eval) through the programs
    against ``graph=False``'s eager loops: the whole training state bit for bit
    (parameters, Adam's state, buffer, generator). The third round's
    replays run under CUDA's sync debug mode "error": the dense round
    whole (its lattice reset, the episode's replay, the insert, the
    updates' replays; the round's timing points synchronise explicitly),
    the large learner's updates (its collection ends in the overflow
    gate, a read on the host by design)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    prog, eager = _learner(large), _learner(large, False)
    prog.train(stop_after=2)
    eager.train(stop_after=3)

    def no_sync(fn, *args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    if large:
        run = prog._updates.run
        prog._updates.run = lambda *a: no_sync(run, *a)
        prog.train(stop_after=3)
    else:
        no_sync(prog.train, stop_after=3)
    assert torch.equal(prog.last_loss_sum, eager.last_loss_sum)
    _same_learners(prog, eager)


@pytest.mark.gpu
def test_resume_into_a_learner_that_captured_on_gpu(tmp_path):
    """A learner whose programs were captured before ``load_training_state``
    resumes a state file in place (parameters, Adam's state, buffer and
    its size, generator) and replays the graphs it had, captured again
    never: its next round equals the uninterrupted run's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim

    state = str(tmp_path / "state.npz")
    full = _learner(False)
    full.train(stop_after=3)
    part = _learner(False)
    part.train(state_path=state, stop_after=2)
    rest = _learner(False, seed=9)
    rest.train(stop_after=2)
    captures = (tim.UpdateProgram.captures, tim.DenseEpisodeProgram.captures)
    rest.load_training_state(state)
    rest.train(stop_after=3)
    assert (tim.UpdateProgram.captures,
            tim.DenseEpisodeProgram.captures) == captures
    _same_learners(full, rest)


@pytest.mark.gpu
def test_graph_true_raises_on_a_one_rank_mesh_on_gpu():
    """On a mesh the round's loops run as programs: ``graph=True`` raises
    only where a program does not apply, on the CPU (off the pcells path
    it builds the learner's programs on the card), and ``graph=None``
    builds the programs (the update program with its collectives). A
    one-rank gloo group, destroyed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    import socket

    import torch.distributed as dist

    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh
    from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
        ShardedImitationLearner)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0,
                                       platform="cpu")
    try:
        mesh = make_mesh(device_type="cpu")
        with pytest.raises(ValueError, match="on the CPU"):
            ShardedImitationLearner(_round_cfg(False), mesh, device="cpu",
                                    graph=True)
        cells = til.LargeNImitationLearner(
            dataclasses.replace(_round_cfg(True), graph_path="cells"),
            device="cuda", mesh=mesh, graph=True)
        assert cells._lcfg.path == "cells" and cells._graph is None
        lrn = ShardedImitationLearner(_round_cfg(False), mesh, device="cuda")
        assert lrn._updates.update == lrn._update and lrn._graph is None
    finally:
        dist.destroy_process_group()


# --- the mesh programs: a one-rank NCCL group in this process ---------------

@pytest.fixture
def nccl_mesh():
    """A one-rank NCCL process group and its ("env", "agents") mesh,
    destroyed after the test (with the episode programs captured on it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (NCCL, CUDA graphs)")
    import socket

    import torch.distributed as dist

    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        yield make_mesh(1, 1)
    finally:
        tln.clear_programs()
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k3", "expert", "stochastic", "n_episodes",
                                  "traj_agents", "force_n_dev"])
def test_mesh_graph_episode_equals_the_eager_loop_on_gpu(nccl_mesh, case):
    """``rollout_large(mesh=)`` on a one-rank NCCL mesh through its episode
    program (a CUDA graph with the band's collectives captured in it: a
    capture, then a replay) against the mesh's eager loop and, on the real
    axis, the episode with no mesh: every output and the generator's
    state bit for bit; the replay's launches on the device (profiler
    trace) those of the eager loop. ``force_n_dev=4``: the emulated rank
    (no collective), graph against eager."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    force = case == "force_n_dev"
    p, kw, k = _graph_case("k3" if force else case)
    if force:
        kw = dict(force_n_dev=4)
    acfg, actor = seeded_actor(k, 0, dev)
    runs = {}
    for name, mesh, graph in (("eager", nccl_mesh, False),
                              ("capture", nccl_mesh, True),
                              ("replay", nccl_mesh, True),
                              ("no mesh", None, False)):
        if force and mesh is None:
            continue
        gen = torch.Generator(device=dev).manual_seed(5)
        captures = tln.EpisodeProgram.captures
        res, launched = tcc.device_launches(lambda: tln.rollout_large(
            actor, acfg, gen, p, device=dev, return_overflow=True,
            mesh=mesh, graph=graph, **kw))
        runs[name] = (res, launched, gen.get_state(),
                      tln.EpisodeProgram.captures - captures)
    clen = -(-GRAPH_T // kw.get("scan_chunks", 1))    # one program a length
    programs = len({min(clen, GRAPH_T - c0) for c0 in range(0, GRAPH_T, clen)})
    assert runs["capture"][3] == programs and runs["replay"][3] == 0
    eager = runs["eager"]
    for name, (res, launched, state, _) in runs.items():
        for a, b in zip(res, eager[0], strict=True):
            assert torch.equal(a, b), name
        assert torch.equal(state, eager[2]), name
    assert runs["replay"][1] == eager[1], (runs["replay"][1], eager[1])
    if not force:
        assert int(eager[0][2]) == 0


@pytest.mark.gpu
def test_mesh_graph_replay_never_waits_for_the_device(nccl_mesh):
    """The sharded grid build, and once captured a whole mesh episode (the
    eager lattice reset with its collectives, the copies into the static
    buffers, the replay with its NCCL calls, the generator's hand-over),
    issue no operation that synchronises the host."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import axis_group
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p, _, k = _graph_case("stochastic")
    acfg, actor = seeded_actor(k, 0, dev)
    spec = tcc.make_pcell_spec(p)
    x = _init_candidate(torch.Generator(device=dev).manual_seed(1), p, dev)
    want = tcc.build_pcell_grid(x[:, :2], spec)
    axis = axis_group(nccl_mesh)
    tcc.build_pcell_grid_sharded(x[:, :2], spec, axis)     # NCCL's comm
    got = _no_sync(tcc.build_pcell_grid_sharded, x[:, :2], spec, axis)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)

    def episode():
        gen = torch.Generator(device=dev).manual_seed(2)
        return tln.rollout_large(actor, acfg, gen, p, device=dev,
                                 return_overflow=True, mesh=nccl_mesh,
                                 graph=True)

    first = episode()                      # captures
    captures = tln.EpisodeProgram.captures
    again = _no_sync(episode)
    assert tln.EpisodeProgram.captures == captures
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("large", [False, True], ids=["dense", "large"])
def test_mesh_program_rounds_equal_eager_rounds_on_gpu(nccl_mesh, large):
    """One DAGGER round (with its eval) of ``ShardedImitationLearner``
    (its slice of the envs through the dense episode program, each update
    with its gradient ``all_reduce`` through the update program) and of
    the large learner on the ("env", "agents") mesh (the banded collection
    and eval programs, the update program), through the programs against
    ``graph=False``: the whole training state bit for bit."""
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
    from multiagent_gnn_policies_tpu_torch.parallel.sharded import (
        ShardedImitationLearner)

    def make(graph):
        if large:
            return til.LargeNImitationLearner(_round_cfg(True), device="cuda",
                                              mesh=nccl_mesh, graph=graph)
        return ShardedImitationLearner(_round_cfg(False), nccl_mesh,
                                       device="cuda", graph=graph)

    prog, eager = make(None), make(False)
    captures = tim.UpdateProgram.captures
    for rounds in (1, 2):        # the first captures, the second replays
        prog.train(stop_after=rounds)
        eager.train(stop_after=rounds)
        assert torch.equal(prog.last_loss_sum, eager.last_loss_sum)
        _same_learners(prog, eager)
    assert tim.UpdateProgram.captures == captures + 1
    assert prog._updates.update == prog._update


@pytest.mark.gpu
def test_a_failed_mesh_capture_raises_on_gpu(nccl_mesh):
    """A mesh program whose step waits for the device (a read on the host
    before the step's collectives) raises at its capture and keeps no
    graph; nothing falls back to the eager loop, and the mesh's next
    program captures and equals the eager loop."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    def syncing_step(cfg, actor, state, gen=None):
        float(state.overflow)
        return tln._step(cfg, actor, state, gen)

    dev = torch.device("cuda")
    p, _, k = _graph_case("k3")
    acfg, actor = seeded_actor(k, 0, dev)
    cfg = tln.make_config(p, mesh=nccl_mesh)
    prog = tln.EpisodeProgram(cfg, acfg, 2, dev, step=syncing_step)
    state = tln._episode_init(cfg, acfg, torch.Generator(
        device=dev).manual_seed(1), dev)
    with pytest.raises(RuntimeError):
        prog.run(state, actor)
    assert not prog.captured
    runs = [tln.rollout_large(actor, acfg, torch.Generator(
        device=dev).manual_seed(3), p, device=dev, mesh=nccl_mesh,
        graph=g) for g in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_a_new_group_captures_anew_on_gpu(nccl_mesh):
    """A program captured on a group that is destroyed refuses to replay
    and is dropped; the same episode on a new group's mesh captures a
    program of its own and equals the first bit for bit."""
    import socket

    import torch.distributed as dist

    from multiagent_gnn_policies_tpu_torch.parallel import distributed
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.parallel.mesh import make_mesh
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p, _, k = _graph_case("k3")
    acfg, actor = seeded_actor(k, 0, dev)

    def episode(mesh):
        return tln.rollout_large(actor, acfg, torch.Generator(
            device=dev).manual_seed(6), p, device=dev, mesh=mesh)

    first = episode(nccl_mesh)
    (old,) = [prog for key, prog in tln._PROGRAMS.items()
              if key[0].axis is not None]
    state = tln._episode_init(old.cfg, acfg, None, dev, _init_candidate(
        torch.Generator(device=dev).manual_seed(1), p, dev))
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group was destroyed"):
        old.run(state, actor)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    captures = tln.EpisodeProgram.captures
    second = episode(make_mesh(1, 1))
    assert tln.EpisodeProgram.captures == captures + 1
    assert old not in tln._PROGRAMS.values()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# --- the compiled DDPG episode ----------------------------------------------

# Each config cut in depth (T, batch, buffer) so that three episodes open
# the update gate after the episode, mid-episode and at the first step,
# and the buffer wraps in the third.
DDPG_GRAPH_CUTS = {("ddpg_toy", "test"): (40, 60, 100),
                   ("ddpg", "test"): (60, 100, 150),
                   ("ddpg_n4k", "n4k"): (6, 8, 16)}


def _ddpg_learner(config, graph=None, seed=None):
    """The learner of a ``cfg/ddpg*.cfg`` section at its full width, cut in
    depth as DDPG_GRAPH_CUTS says, routed as the train CLI routes it."""
    import dataclasses
    import pathlib

    from multiagent_gnn_policies_tpu_torch.algos.ddpg import DDPG, DDPGConfig
    from multiagent_gnn_policies_tpu_torch.algos.ddpg_large import DDPGLarge
    from multiagent_gnn_policies_tpu_torch.utils.config import (
        ExperimentConfig, load_ini)

    path = pathlib.Path(__file__).resolve().parent.parent / "cfg" / (
        f"{config[0]}.cfg")
    xcfg = ExperimentConfig.from_section(load_ini(str(path))[config[1]])
    steps, batch, cap = DDPG_GRAPH_CUTS[config]
    cfg = DDPGConfig.from_experiment(xcfg)
    cfg = dataclasses.replace(
        cfg, batch_size=batch, buffer_size=cap,
        seed=cfg.seed if seed is None else seed,
        env=dataclasses.replace(cfg.env, episode_steps=steps))
    cls = DDPGLarge if xcfg.n_agents > 1024 else DDPG
    return cls(cfg, device="cuda", graph=graph)


def _no_sync(fn, *args):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
@pytest.mark.parametrize("config", list(DDPG_GRAPH_CUTS),
                         ids=[c[0] for c in DDPG_GRAPH_CUTS])
def test_ddpg_graph_episodes_equal_the_eager_loop_on_gpu(config):
    """Three training episodes through the CUDA graphs (one per gate step:
    after the episode, mid-episode, the first step; the buffer wraps in
    the third) against the eager loop (``graph=False``): each episode's
    summed reward and losses, then the whole training state (networks,
    targets, both Adam states, the buffer, the generator) bit for bit; a
    fourth episode's replay (behind its eager reset) under CUDA's sync
    debug mode "error", bit for bit again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.utils import graphs

    prog, eager = _ddpg_learner(config, True), _ddpg_learner(config, False)
    steps, batch, _ = DDPG_GRAPH_CUTS[config]
    opens = []
    for ep in range(3):
        opens.append(prog._gate_opens())
        got, want = prog.episode(), eager.episode()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), ep
    assert opens == [steps, batch - steps, 0]
    assert float(got[1]) > 0.0 and prog.buffer.cursor < steps
    _same_learners(prog, eager)
    captures = graphs.Program.captures
    start = prog._start()
    got = _no_sync(prog._run_program, start, None, None, 0)
    assert graphs.Program.captures == captures
    want = eager.episode()
    assert torch.equal(got, torch.stack(want))
    _same_learners(prog, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("env", ["FlockingRelative-v0",
                                 "FlockingStochastic-v0"])
def test_ddpg_eval_programs_equal_the_eager_loops_on_gpu(env):
    """The dense eval (``eval_episodes``, 10 episodes as one batch) through
    its episode program, a capture and a replay, and the positions
    record's eval (3 episodes, each replayed behind its reset) against the
    eager loops: rewards and the generator's state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    import dataclasses

    from multiagent_gnn_policies_tpu_torch.algos import ddpg as tdd
    from multiagent_gnn_policies_tpu_torch.envs.flocking import make_env

    lrn = _ddpg_learner(("ddpg", "test"), False)
    e = make_env(env, lrn.cfg.env)
    out = []
    for graph in (False, True, True):        # eager, capture, replay
        gen = torch.Generator(device="cuda").manual_seed(4)
        r = tdd.eval_episodes(lrn.actor, e, lrn.cfg.actor, gen, 10,
                              graph=graph)
        out.append((r, gen.get_state()))
    for r, g in out[1:]:
        assert torch.equal(r, out[0][0]) and torch.equal(g, out[0][1])
    large = [_ddpg_learner(("ddpg_n4k", "n4k"), graph) for graph in
             (True, False)]
    noise = 0.1 if env == "FlockingStochastic-v0" else 0.0
    for lrn in large:
        lrn.params = dataclasses.replace(lrn.params, dynamics_noise=noise)
    for _ in range(2):
        got, want = (lrn.eval_rewards() for lrn in large)
        assert (got == want).all() and torch.equal(
            large[0].gen.get_state(), large[1].gen.get_state())


@pytest.mark.gpu
def test_ddpg_resume_into_a_learner_that_captured_on_gpu(tmp_path):
    """A learner whose episode graphs were captured (another seed's three
    episodes) loads a state file saved after two episodes in place and
    replays the graph it has, captured again never: its third episode
    equals the uninterrupted run's training state bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.utils import graphs

    config = ("ddpg_toy", "test")
    state = str(tmp_path / "state.npz")
    full = _ddpg_learner(config)
    full.train(stop_after=3)
    part = _ddpg_learner(config)
    assert part.train(state_path=state, stop_after=2)["interrupted"]
    rest = _ddpg_learner(config, seed=9)
    rest.train(stop_after=3)
    captures = (graphs.Program.captures, tim.DenseEpisodeProgram.captures)
    rest.load_training_state(state)
    rest.train(stop_after=3)
    assert (graphs.Program.captures,
            tim.DenseEpisodeProgram.captures) == captures
    _same_learners(full, rest)


@pytest.mark.gpu
def test_ddpg_capturable_adam_against_adam_on_gpu():
    """The capturable Adam the learner builds on the card against the Adam
    without it, five gradient steps on the same batches of the buffer an
    episode filled: every network and target within 1e-6 of each tensor's
    largest magnitude (the tolerance ``tests/test_torch_imitation.py``
    holds Adam to against optax.adam) plus what the capturable Adam's
    float32 bias corrections allow. It computes ``1 - beta2 ** t`` in
    float32 on the device (as optax does), the Adam without it in double
    on the host: at t = 1 the float32 difference ``1 - 0.999`` is
    1.3e-5 off, which moves an update (at most ADAM_STEP_MAX · lr) by
    that share. A small tensor (the critic's output bias, ~1e-3) shows
    it: 2e-6 to 2e-5 of its magnitude per step on the card, where two
    capturable Adams agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import numpy as np

    config = ("ddpg_toy", "test")
    lrn, ref = _ddpg_learner(config, False), _ddpg_learner(config, False)
    assert lrn.actor_opt.defaults["capturable"]
    ref.actor_opt = torch.optim.Adam(ref.actor.parameters(),
                                     lr=ref.cfg.actor_lr)
    ref.critic_opt = torch.optim.Adam(ref.critic.parameters(),
                                      lr=ref.cfg.critic_lr)
    lrn.episode()                  # 40 records; the gate stays closed
    draws = torch.Generator(device="cuda").manual_seed(2)
    steps = 5
    for _ in range(steps):
        batch = lrn.buffer.sample(draws, 30)
        lrn.gradient_step(batch)
        ref.gradient_step(batch)
    bc_rel = abs(float(np.float32(1.0) - np.float32(0.999)) / 0.001 - 1.0)
    adam_step_max = (1 - 0.9) / (1 - 0.999) ** 0.5
    for name, m in lrn._modules().items():
        lr = lrn.cfg.actor_lr if name.startswith("actor") else (
            lrn.cfg.critic_lr)
        for g, w in zip(m.parameters(), ref._modules()[name].parameters()):
            err = float((g - w).abs().max())
            bound = (1e-6 * float(w.abs().max())
                     + steps * adam_step_max * lr * bc_rel)
            assert err <= bound, (name, err, bound)


# --- the episode program off pcells, and the trajectory program -------------


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["blocked", "cells", "binned"])
@pytest.mark.parametrize("case", ["k3", "stochastic", "expert_chunks",
                                  "traj_agents", "n_episodes"])
def test_backend_graph_episode_equals_the_eager_loop_on_gpu(path, case):
    """``rollout_large(path=)`` on the blocked, cells and binned paths
    through its episode program (CUDA graphs: a capture, then a replay)
    against the eager loop on the same generator: every output and the
    generator's state bit for bit; one program captured per chunk length,
    its graphs' nodes counted."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    dev = torch.device("cuda")
    p, kw, k = _graph_case(case)
    acfg, actor = seeded_actor(k, 0, dev)
    tln.clear_programs()
    out = {}
    for name, graph in (("eager", False), ("capture", True),
                        ("replay", True)):
        gen = torch.Generator(device=dev).manual_seed(5)
        out[name] = (tln.rollout_large(actor, acfg, gen, p, device=dev,
                                       return_overflow=True, path=path,
                                       graph=graph, **kw), gen.get_state())
    for name in ("capture", "replay"):
        for a, b in zip(out[name][0], out["eager"][0], strict=True):
            assert torch.equal(a, b), name
        assert torch.equal(out[name][1], out["eager"][1]), name
    assert int(out["eager"][0][2]) == 0
    progs = list(tln._PROGRAMS.values())
    assert progs and all(prog.captured and prog.nodes > 0 for prog in progs)


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["blocked", "cells", "binned"])
def test_backend_graph_replay_never_waits_for_the_device(path):
    """Once captured, an episode on ``path`` through its program (the eager
    lattice reset, the copies into the static buffers, the replays of its
    chunks with their inputs and outputs copied, the generator's
    hand-over) issues no operation that synchronises the host; its
    program in graphs of 5 steps (5, 5, 3) equals the eager loop."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the host-sync check is CUDA's)")
    dev = torch.device("cuda")
    p, _, k = _graph_case("stochastic")
    acfg, actor = seeded_actor(k, 0, dev)
    cfg = tln.make_config(p, path=path)
    prog = tln.EpisodeProgram(cfg, acfg, GRAPH_T, dev, steps_per_graph=5)

    def episode(graph):
        gen = torch.Generator(device=dev).manual_seed(2)
        state = tln._episode_init(cfg, acfg, gen, dev)
        if not graph:
            return tln._scan_steps(cfg, actor, state, GRAPH_T, gen)[1]
        prog.run(state, actor, gen)
        return prog.rewards.clone()

    first = episode(True)                  # captures
    again = _no_sync(episode, True)
    assert prog._chunks() == [(0, 5), (5, 5), (10, 3)]
    assert torch.equal(first, again)
    assert torch.equal(again, episode(False))


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["cells", "blocked"])
def test_backend_graph_collection_in_chunks_on_gpu(path):
    """The large learner's DAGGER collection on ``path`` through its
    program, whole and in graphs of 4 steps (the subsample and coin
    copied in per chunk, the records out), against the eager loop:
    records, reward, overflow and the generator's state bit for bit."""
    from multiagent_gnn_policies_tpu_torch.algos import imitation_large as til
    from multiagent_gnn_policies_tpu_torch.envs.flocking import ENV_REGISTRY
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    dev = torch.device("cuda")
    p = ENV_REGISTRY["FlockingStochastic-v0"](
        FlockingParams(n_agents=GRAPH_N, episode_steps=GRAPH_T))
    cfg = tln.make_config(p, path=path, need_expert=True)
    acfg, actor = seeded_actor(3, 0, dev)

    def collect(graph):
        gen = torch.Generator(device=dev).manual_seed(8)
        samples, r, ovf = til.collect_episode(cfg, actor, acfg, "dagger",
                                              256, gen, 0.5, dev, graph=graph)
        return samples["agg"], samples["act"], r, ovf, gen.get_state()

    want = collect(False)
    tln.clear_programs()
    for per_graph in (None, 4):
        prog = til.collection_program(cfg, acfg, "dagger", 256, dev)
        prog.steps_per_graph = per_graph
        for _ in range(2):                 # capture, replay
            got = collect(True)
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b), per_graph
        tln.clear_programs()


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["blocked", "cells", "binned"])
def test_mesh_backend_graph_equals_the_eager_loop_on_gpu(nccl_mesh, path):
    """``rollout_large(mesh=, path=)`` on a one-rank NCCL mesh through its
    program (the frames' gathers, the applies' collectives and the state
    gather captured: a capture, then a replay) against the mesh's eager
    loop and the episode with no mesh, bit for bit; ``force_n_dev=2``
    (the emulated rank, no collective) through its program against its
    eager loop."""
    from multiagent_gnn_policies_tpu_torch.parallel import large_n as tln
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    dev = torch.device("cuda")
    p, _, k = _graph_case("stochastic")
    acfg, actor = seeded_actor(k, 0, dev)
    runs = []
    for mesh, graph in ((nccl_mesh, False), (nccl_mesh, True),
                        (nccl_mesh, True), (None, False)):
        gen = torch.Generator(device=dev).manual_seed(5)
        runs.append(tln.rollout_large(actor, acfg, gen, p, device=dev,
                                      return_overflow=True, mesh=mesh,
                                      path=path, graph=graph)
                    + (gen.get_state(),))
    for run in runs[1:]:
        for a, b in zip(run, runs[0], strict=True):
            assert torch.equal(a, b)
    assert int(runs[0][2]) == 0
    forced = [tln.rollout_large(actor, acfg, torch.Generator(
        device=dev).manual_seed(5), p, device=dev, return_overflow=True,
        mesh=nccl_mesh, force_n_dev=2, path=path, graph=graph)
        for graph in (False, True, True)]
    for run in forced[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, forced[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("env", ["FlockingRelative-v0",
                                 "FlockingStochastic-v0"])
def test_trajectory_program_equals_the_eager_loop_on_gpu(env):
    """``rollout_trajectory`` through its program (the reset eager, the T
    steps one CUDA graph: a capture, then a replay) against its eager loop
    from one generator: states, rewards and the generator's state bit for
    bit; the replay waits for the device nowhere."""
    from multiagent_gnn_policies_tpu_torch.algos import imitation as tim
    from multiagent_gnn_policies_tpu_torch.envs.flocking import make_env
    from multiagent_gnn_policies_tpu_torch.scripts._common import (
        seeded_actor)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA graphs)")
    dev = torch.device("cuda")
    fenv = make_env(env, FlockingParams(n_agents=100, episode_steps=50))
    acfg, actor = seeded_actor(3, 0, dev)

    def run(graph):
        gen = torch.Generator(device=dev).manual_seed(4)
        return tim.rollout_trajectory(actor, gen, fenv, acfg,
                                      graph=graph) + (gen.get_state(),)

    want = run(False)
    captures = tim.TrajectoryProgram.captures
    for got in (run(True), run(True)):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b)
    assert tim.TrajectoryProgram.captures == captures + 1
    renv = make_env("FlockingRelative-v0",
                    FlockingParams(n_agents=100, episode_steps=50))
    x0 = torch.zeros((100, 4), device=dev)
    x0[:, 0] = torch.arange(100, device=dev) % 10 * 0.5
    x0[:, 1] = torch.arange(100, device=dev) // 10 * 0.5
    want = tim.rollout_trajectory(actor, None, renv, acfg, x0, graph=False)
    tim.rollout_trajectory(actor, None, renv, acfg, x0)        # captures
    got = _no_sync(tim.rollout_trajectory, actor, None, renv, acfg, x0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
