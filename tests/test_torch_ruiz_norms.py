"""The Ruiz pass kernels (``ops/ruiz_norms.py``, ``csrc/ruiz_norms.cu``).

On the CPU: the wrappers run their plain versions, which Ruiz's JAX parity
tests (``test_torch_ruiz.py``, ``test_torch_multistage.py``,
``test_torch_horizon_local.py``) hold; here, the plain norms against a
direct computation from scaled copies of the blocks.

On the card (marker ``card``; imports no JAX, so it runs with
``--noconftest``): each norm and scale instance and the step against its
plain version on the same CUDA tensors, bit for bit, in float32 and
float64, at the cells' shapes and at odd ones; ``equilibrate`` on CUDA
against the CPU, with no host sync, and one norm launch a pass (two under
``scale_cost``)."""

import dataclasses

import pytest
import torch

from piqp_tpu_torch import multistage as tms
from piqp_tpu_torch import prepare_batch, ruiz
from piqp_tpu_torch.ops import ruiz_norms
from piqp_tpu_torch.types import concat
from piqp_tpu_torch.utils.random import dense_strongly_convex_qp

DENSE = {"cell": dict(B=1024, n=128, p=64, m=64), "odd": dict(B=3, n=37, p=5, m=0),
         "single": dict(B=1, n=130, p=0, m=7), "cost_only": dict(B=5, n=40, p=0, m=0)}
STAGE = {"cell": dict(B=1024, T=40, D=24, Da=0, ra=21, rg=0),
         "odd": dict(B=3, T=7, D=5, Da=3, ra=2, rg=4),
         "single": dict(B=1, T=5, D=24, Da=2, ra=0, rg=3),
         "slice": dict(B=4, T=9, D=6, Da=2, ra=3, rg=2, own=(2, 6)),
         "cost_only": dict(B=4, T=8, D=7, Da=2, ra=0, rg=0),
         # a stage of 73 KB in float64: two slots of shared memory, not three
         "wide": dict(B=2, T=3, D=48, Da=1, ra=40, rg=3),
         # a stage of 270 KB in float64, 135 KB in float32: read where it lies
         "huge": dict(B=2, T=3, D=100, Da=2, ra=60, rg=5)}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _rnd(g, dtype, device, *shape):
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype).to(device)


def _pos(g, dtype, device, *shape):
    return torch.empty(shape, dtype=torch.float64).uniform_(0.3, 3.0, generator=g).to(
        dtype).to(device)


def _dense_inputs(B, n, p, m, dtype, device, seed=0):
    """P, A, G, the scalings dx, dy, dz of a pass, active."""
    g = _gen(seed)
    active = (torch.arange(B) % 3 != 1).to(device)
    return (_rnd(g, dtype, device, B, n, n), _rnd(g, dtype, device, B, p, n),
            _rnd(g, dtype, device, B, m, n), _pos(g, dtype, device, B, n),
            _pos(g, dtype, device, B, p), _pos(g, dtype, device, B, m), active)


def _stage_inputs(B, T, D, Da, ra, rg, dtype, device, own=None, seed=0):
    """The owned stages' blocks (narrow views of whole-horizon blocks when
    ``own`` is given), the whole horizon's scalings of a pass dx, dg, dy,
    dz, active, start."""
    g = _gen(seed)
    shapes = dict(Pd=(D, D), Psub=(D, D), Pa=(Da, D), A1=(ra, D), A2=(ra, D), Ag=(ra, Da),
                  G1=(rg, D), G2=(rg, D), Gg=(rg, Da))
    blocks = tuple(_rnd(g, dtype, device, B, T, *shapes[k]) for k in ruiz_norms.STAGE_BLOCKS)
    start = 0
    if own is not None:
        start = own[0]
        blocks = tuple(M[:, own[0]:own[1]] for M in blocks)
    active = (torch.arange(B) % 3 != 1).to(device)
    return (blocks, _pos(g, dtype, device, B, T, D), _pos(g, dtype, device, B, Da),
            _pos(g, dtype, device, B, T, ra), _pos(g, dtype, device, B, T, rg), active, start)


def test_plain_versions_are_the_norms_of_the_blocks():
    """The plain norms against those of the dense KKT matrix, and the plain
    stage scaling against the dense scaling of that matrix (to rounding:
    P's upper blocks, Psub transposed, take their two factors in the other
    order)."""
    P, A, G, dx, dy, dz, active = _dense_inputs(4, 9, 3, 4, torch.float64, "cpu")
    K = torch.cat([P, A, G], 1)
    want = torch.cat([K.abs().amax(1), A.abs().amax(2), G.abs().amax(2)], 1)
    torch.testing.assert_close(ruiz_norms.dense_norms(P, A, G, active),
                               torch.where(active[:, None], want, 0.0), rtol=0, atol=0)

    blocks, dx, dg, dy, dz, active, start = _stage_inputs(3, 5, 3, 2, 2, 1, torch.float64, "cpu")
    for k in (1, 4, 7):  # Psub, A2, G2 couple the last stage to none
        blocks[k][:, -1] = 0.0
    z = dict(dtype=torch.float64)
    data = tms.StageQPData(
        c=torch.zeros(3, 17, **z), b=torch.zeros(3, 10, **z), h_l=torch.zeros(3, 5, **z),
        h_u=torch.zeros(3, 5, **z), x_l=torch.zeros(3, 17, **z), x_u=torch.zeros(3, 17, **z),
        x_b_scaling=torch.zeros(3, 17, **z),
        hl_mask=torch.zeros(3, 5, dtype=torch.bool), hu_mask=torch.zeros(3, 5, dtype=torch.bool),
        xl_mask=torch.zeros(3, 17, dtype=torch.bool), xu_mask=torch.zeros(3, 17, dtype=torch.bool),
        Pc=torch.zeros(3, 2, 2, **z), **dict(zip(ruiz_norms.STAGE_BLOCKS, blocks)))
    dense = tms.to_dense(data)
    K = torch.cat([dense.P, dense.A, dense.G], 1)
    want = torch.cat([K.abs().amax(1), K[:, 17:].abs().amax(2)], 1)
    torch.testing.assert_close(ruiz_norms.stage_norms(blocks, active, 0, 5),
                               torch.where(active[:, None], want, 0.0), rtol=0, atol=0)

    ruiz_norms.stage_scale(blocks, dx, dg, dy, dz, active, 0)
    scaled = tms.to_dense(dataclasses.replace(data, **dict(zip(ruiz_norms.STAGE_BLOCKS, blocks))))
    s_x = torch.cat([dx.flatten(1), dg], 1)
    on = active[:, None, None]
    for got, M, rows in ((scaled.P, dense.P, s_x), (scaled.A, dense.A, dy.flatten(1)),
                         (scaled.G, dense.G, dz.flatten(1))):
        want = torch.where(on, rows[:, :, None] * M * s_x[:, None, :], M)
        torch.testing.assert_close(got, want, rtol=1e-15, atol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(DENSE))
def test_card_dense_kernel_is_its_plain_version(card, case, dtype):
    P, A, G, *_, active = _dense_inputs(**DENSE[case], dtype=getattr(torch, dtype),
                                        device=card, seed=1)
    before = dict(ruiz_norms.launches_by_shape)
    got = ruiz_norms.dense_norms(P, A, G, active)
    want = ruiz_norms.dense_norms_reference(P, A, G, active)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max()
    c = DENSE[case]
    key = f"dense:{dtype}:n{c['n']}xp{c['p']}xm{c['m']}"
    assert ruiz_norms.launches_by_shape[key] == before.get(key, 0) + 1


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(STAGE))
def test_card_stage_kernel_is_its_plain_version(card, case, dtype):
    blocks, *_, active, start = _stage_inputs(**STAGE[case], dtype=getattr(torch, dtype),
                                              device=card, seed=2)
    T = STAGE[case]["T"]
    before = dict(ruiz_norms.launches_by_shape)
    got = ruiz_norms.stage_norms(blocks, active, start, T)
    want = ruiz_norms.stage_norms_reference(blocks, active, start, T)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (got - want).abs().max()
    c = STAGE[case]
    Tl = blocks[0].shape[1]
    key = f"stage:{dtype}:T{Tl}xD{c['D']}xra{c['ra']}xrg{c['rg']}xDa{c['Da']}"
    assert ruiz_norms.launches_by_shape[key] == before.get(key, 0) + 1


def _dense_batch(B=64, device="cpu"):
    probs = [dense_strongly_convex_qp(40, 10, 12, seed=i) for i in range(B)]
    probs[1]["P"] = probs[1]["P"] * 1e4
    return prepare_batch(probs, device=device)


def _stage_batch(device="cpu"):
    datas = [tms.random_multistage_qp(T=6, D=5, Da=2, ra=3, rg=2, seed=s, device=device)
             for s in range(8)]
    data = concat(datas)
    return dataclasses.replace(data, Pd=data.Pd * torch.linspace(1, 300, 8, device=device)[
        :, None, None, None].to(data.Pd.dtype))


@pytest.mark.card
@pytest.mark.parametrize("scale_cost", [False, True], ids=["plain", "scale_cost"])
@pytest.mark.parametrize("kind", ["dense", "stage"])
def test_card_equilibrate_is_the_cpus_with_no_sync(card, kind, scale_cost):
    """On CUDA: the CPU's scalings and scaled data (float64, to 1e-13: only
    the cost's sum of column norms may add in another order), no host sync
    while it runs, and one launch a pass, two under ``scale_cost``."""
    make = _dense_batch if kind == "dense" else _stage_batch
    cpu, gpu = make(device="cpu"), make(device=card)
    want, want_s = ruiz.equilibrate(cpu, scale_cost=scale_cost)
    ruiz.equilibrate(gpu, scale_cost=scale_cost)  # builds the library, warms the allocator
    torch.cuda.synchronize()
    before = dict(ruiz_norms.launches_by_shape)
    steps = dict(ruiz_norms.pass_launches_by_kind)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, got_s = ruiz.equilibrate(gpu, scale_cost=scale_cost)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launched = {k: v - before.get(k, 0) for k, v in ruiz_norms.launches_by_shape.items()
                if v != before.get(k, 0)}
    assert sorted(launched.values()) == [10] * (2 if scale_cost else 1), launched
    assert ruiz_norms.pass_launches_by_kind == dict(step=steps["step"] + 10,
                                                    scale=steps["scale"] + 10)
    for name in ("c", "d_x", "d_y", "d_z", "d_b"):
        torch.testing.assert_close(getattr(got_s, name).cpu(), getattr(want_s, name),
                                   rtol=1e-13, atol=0, msg=name)
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        if w.is_floating_point():
            torch.testing.assert_close(getattr(got, f.name).cpu(), w, rtol=1e-13, atol=1e-15,
                                       msg=f.name)


@pytest.mark.card
def test_card_sharded_holder_reads_its_own_stages(card):
    """A rank's ``ShardedStageQPData`` (stages [3, 6) of 9, compact copies)
    on the card: its norms with the spill row, and its blocks scaled by a
    pass, bitwise the plain versions'."""
    from piqp_tpu_torch.parallel.horizon import _take_stages

    datas = [tms.random_multistage_qp(T=9, D=5, Da=2, ra=3, rg=2, seed=s, device=card)
             for s in range(3)]
    held = _take_stages(concat(datas), (3, 6))
    active = torch.tensor([True, False, True], device=card)
    blocks = tuple(getattr(held, k).clone() for k in ruiz_norms.STAGE_BLOCKS)
    got = ruiz_norms.stage_norms(blocks, active, 3, 9)
    want = ruiz_norms.stage_norms_reference(blocks, active, 3, 9)
    torch.cuda.synchronize()
    assert got.shape == (3, 4 * 5 + 2 + 3 * 3 + 3 * 2)
    assert torch.equal(got, want)
    g = torch.Generator().manual_seed(5)
    s = torch.empty(3, 2 * held.n + held.p + held.m, dtype=torch.float64).uniform_(
        0.3, 3.0, generator=g).to(card)
    want = tuple(M.clone() for M in blocks)
    ruiz_norms.stage_scale(blocks, *tms._stage_scalings(held, s), active, 3)
    ruiz_norms.stage_scale_reference(want, *tms._stage_scalings(held, s), active, 3)
    torch.cuda.synchronize()
    for M, W in zip(blocks, want):
        assert torch.equal(M, W)


def _step_inputs(B, n, pm, Da, dtype, device, seed=3):
    g = _gen(seed)

    def pos(*shape):
        return torch.empty(shape, dtype=torch.float64).uniform_(1e-5, 3e4, generator=g).to(
            dtype).to(device)

    norms, xb = pos(B, n + pm), pos(B, n)
    xb[:, ::3] = 0.0
    Pc = torch.randn((B, Da, Da), generator=g, dtype=torch.float64).to(dtype).to(device)
    state = dict(d=pos(B, 2 * n + pm) / 1e4, s=pos(B, 2 * n + pm), xb=xb,
                 cvec=torch.randn((B, n), generator=g, dtype=torch.float64).to(dtype).to(device),
                 measure=pos(B))
    active = (torch.arange(B) % 4 != 2).to(device)
    return norms, Pc, state, active


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(1024, 960, 840, 0), (3, 17, 9, 2), (1, 130, 0, 0)],
                         ids=["chainmass5", "odd", "single"])
def test_card_steps_are_their_plain_versions(card, shape, dtype):
    """The step kernel bitwise its plain version."""
    B, n, pm, Da = shape
    dt = getattr(torch, dtype)
    norms, Pc, state, active = _step_inputs(B, n, pm, Da, dt, card)
    got = {k: v.clone() for k, v in state.items()}
    want = {k: v.clone() for k, v in state.items()}
    for st, step in ((got, ruiz_norms.ruiz_step), (want, ruiz_norms.ruiz_step_reference)):
        step(norms, Pc, st["d"], st["s"], st["xb"], st["cvec"], st["measure"], active)
    torch.cuda.synchronize()
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(DENSE))
def test_card_dense_scale_is_its_plain_version(card, case, dtype):
    P, A, G, dx, dy, dz, active = _dense_inputs(**DENSE[case], dtype=getattr(torch, dtype),
                                                device=card, seed=4)
    want = tuple(M.clone() for M in (P, A, G))
    ruiz_norms.dense_scale(P, A, G, dx, dy, dz, active)
    ruiz_norms.dense_scale_reference(*want, dx, dy, dz, active)
    torch.cuda.synchronize()
    for got, w in zip((P, A, G), want):
        assert torch.equal(got, w)


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", list(STAGE))
def test_card_stage_scale_is_its_plain_version(card, case, dtype):
    """Every block scaled bitwise as the plain version scales it, an owned
    slice in place inside its whole-horizon tensor; the stages outside the
    slice are not touched."""
    blocks, dx, dg, dy, dz, active, start = _stage_inputs(
        **STAGE[case], dtype=getattr(torch, dtype), device=card, seed=5)
    whole = tuple(M._base if M._base is not None else M for M in blocks)
    want = tuple(M.clone() for M in whole)
    ruiz_norms.stage_scale(blocks, dx, dg, dy, dz, active, start)
    ruiz_norms.stage_scale_reference(tuple(M[:, start:start + blocks[0].shape[1]] for M in want),
                                     dx, dg, dy, dz, active, start)
    torch.cuda.synchronize()
    for got, w in zip(whole, want):
        assert torch.equal(got, w)
