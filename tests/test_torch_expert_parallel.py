"""Port parity, expert parallelism's pieces with no ranks: the global slot
arithmetic (`models.moe.global_slots`) over every split of a
microbatch's rows between ranks, `moe_apply` over row blocks and expert
blocks with the ranks' sums done here, and the autograd pair
(`distributed.expert.copy_to` / `reduce_from`) on a one-rank gloo group.
The ranks themselves run in tests/test_torch_train_sharded.py.

Tolerances: slots and kept masks are integers, exact. `moe_apply` in f32:
a row block's output equals the one-process output's rows within 1e-6
(the expert products run on a buffer of another shape); the sum of the
expert blocks' partials, added in f32 in another order, within 1e-6.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced_config
from repro_torch.distributed import expert
from repro_torch.models import moe

E, K = 6, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drawn_ids(seed, N):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([rng.permutation(E)[:K]
                                      for _ in range(N)])).long()


def _crowded_ids(N):
    """Every token's first choice expert 0, its second 1..E-1 in turn:
    expert 0's queue runs through every row."""
    return torch.tensor([[0, 1 + t % (E - 1)] for t in range(N)])


def _split_slots(ids, cuts, C):
    """Each part of the rows between `cuts` placed as a rank places its
    own: `global_slots` with the counts of the parts ahead of it."""
    total = moe.expert_counts(ids, E)
    before = torch.zeros_like(total)
    slots, kept = [], []
    for a, b in zip((0,) + cuts, cuts + (ids.shape[0],)):
        s, k = moe.global_slots(ids[a:b], before, total, C)
        slots.append(s)
        kept.append(k)
        before = before + moe.expert_counts(ids[a:b], E)
    return torch.cat(slots), torch.cat(kept)


CASES = [("drawn", 0, 24, 3), ("drawn", 1, 24, 8), ("drawn", 2, 24, 48),
         ("crowded", None, 24, 5), ("crowded", None, 24, 12),
         ("crowded", None, 13, 4)]


@pytest.mark.parametrize("kind,seed,N,C", CASES,
                         ids=[f"{k}-{s}-{n}-C{c}" for k, s, n, c in CASES])
def test_global_slots_over_every_split(kind, seed, N, C):
    """Two ranks at every boundary of the rows, and three at every pair of
    boundaries: the ranks' slots and kept masks laid end to end equal
    `slot_assignments` over the whole microbatch, the overflow quirk (an
    overflowing expert loses slot C - 1) included wherever it falls."""
    ids = _drawn_ids(seed, N) if kind == "drawn" else _crowded_ids(N)
    want = moe.slot_assignments(ids, E, C)
    overflow = bool((moe.expert_counts(ids, E) > C).any())
    assert overflow == (C < N)
    for n in (1, 2):
        for cuts in itertools.combinations(range(N + 1), n):
            got = _split_slots(ids, cuts, C)
            assert torch.equal(got[0], want[0]), cuts
            assert torch.equal(got[1], want[1]), cuts


def test_split_inside_a_queue_moves_the_lost_slot():
    """Expert 0's queue crosses the boundary and its slot C - 1 lies on the
    second rank: that rank drops it, though its own count alone is under
    C; taking capacity per rank would keep it and more."""
    ids, C = _crowded_ids(12), 8
    total = moe.expert_counts(ids, E)
    first = moe.expert_counts(ids[:4], E)
    slot, kept = moe.global_slots(ids[4:], first, total, C)
    on_second = (ids[4:].reshape(-1) == 0)
    assert int(first[0]) == 4 and int(total[0]) == 12 > C
    assert int(on_second.sum()) == 8 < 12
    lost = on_second & (slot == C - 1)
    assert int(lost.sum()) == 1 and not bool(kept[lost])
    assert int((kept & on_second).sum()) == C - 1 - 4
    # alone, the rank's 8 assignments to expert 0 fit its C: all kept
    alone = moe.slot_assignments(ids[4:], E, C)[1]
    assert int((alone & on_second).sum()) == 8


class _Blocks:
    """An `ExpertGroups` stand-in for rank (row block r of n, expert block
    j of m): the counts are this process's, `reduce_from_experts` keeps
    the partial for the test to sum."""

    def __init__(self, before, total, n, j):
        self.before, self.total, self.row_size = before, total, n
        self.model_index, self.partials = j, []

    def counts(self, local):
        return self.before, self.total

    def copy_to_experts(self, x):
        return x

    def reduce_from_experts(self, x):
        self.partials.append(x)
        return x


def _cfg(shared, factor):
    return get_reduced_config("dbrx-132b").replace(
        d_model=48, moe_d_ff=80,
        n_experts=E, experts_per_token=K, dtype=torch.float32,
        mlp_type="swiglu", n_shared_experts=shared,
        capacity_factor=factor)


def _params(cfg):
    g = torch.Generator().manual_seed(3)
    return moe.moe_init(g, cfg, "cpu")


@pytest.mark.parametrize("n,m", [(2, 1), (1, 2), (2, 3), (4, 2)])
@pytest.mark.parametrize("factor", [0.5, 1.25])
def test_moe_apply_over_blocks_equals_one_process(n, m, factor):
    """x's rows in n blocks and the experts in m: each row block's outputs
    summed over the expert blocks (f32, rounded once) equal the one-
    process outputs' rows; the load-balance terms' mean over the row
    blocks and the z terms' mean equal the one-process terms; the one-
    process routing drops assignments at factor 0.5."""
    cfg = _cfg(0, factor)
    p = _params(cfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 9, cfg.d_model)).astype(np.float32))
    y, aux = moe.moe_apply(p, x, cfg)
    _, _, _, ids = moe.route(x.reshape(-1, cfg.d_model), p["router"], K)
    C = moe.capacity(ids.shape[0], cfg, False)
    assert (int((~moe.slot_assignments(ids, E, C)[1]).sum()) > 0) == \
        (factor < 1)
    rows = x.shape[0] // n
    total = moe.expert_counts(ids, E)
    lb, zl = [], []
    for r in range(n):
        mine = ids[r * rows * 9:(r + 1) * rows * 9]
        before = moe.expert_counts(ids[:r * rows * 9], E)
        parts, terms = [], []
        for j in range(m):
            El = E // m
            pj = dict(p, **{k: p[k][j * El:(j + 1) * El]
                            for k in ("w_up", "w_gate", "w_down")})
            g = _Blocks(before, total, n, j)
            yj, aux_j = moe.moe_apply(pj, x[r * rows:(r + 1) * rows], cfg,
                                      groups=g)
            parts.append(g.partials[0] if m > 1 else yj.reshape(-1, 48))
            terms.append((float(aux_j["lb_loss"]), float(aux_j["z_loss"])))
        # every expert block routes the same rows alike
        assert len(set(terms)) == 1
        assert moe.expert_counts(mine, E).sum() == rows * 9 * K
        got = torch.sum(torch.stack(parts), 0)
        np.testing.assert_allclose(
            got.numpy(), y[r * rows:(r + 1) * rows].reshape(-1, 48).numpy(),
            rtol=0, atol=1e-6)
        lb.append(terms[0][0])
        zl.append(terms[0][1])
    np.testing.assert_allclose(np.mean(lb), float(aux["lb_loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(np.mean(zl), float(aux["z_loss"]),
                               rtol=1e-6)


@pytest.fixture
def one_rank(tmp_path):
    """A gloo world of one rank in this process, torn down after."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.new_group([0])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_pair_on_one_rank(one_rank, dtype):
    """`copy_to` is the identity forward and passes the gradient summed
    over the group (here itself); `reduce_from` sums the partials forward
    and passes the gradient unchanged; both keep the input's dtype."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(dtype).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(
        np.float32)).to(dtype)
    a = expert.copy_to(x, one_rank)
    assert a.dtype == dtype and torch.equal(a, x)
    s = expert.reduce_from(a * 3, one_rank)
    assert s.dtype == dtype and torch.equal(s, (x * 3).detach())
    (gx,) = torch.autograd.grad(torch.sum(s * w), x)
    assert gx.dtype == dtype
    assert torch.equal(gx, w * 3)
    (gw,) = torch.autograd.grad(
        torch.sum(expert.copy_to(x, one_rank) * w), x)
    assert torch.equal(gw, w)
