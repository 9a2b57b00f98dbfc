"""B16's decode rows and B7, the quantized fused MLP, redesigned for Hopper
on one tensor-core GEMV (``ops/csrc/mma_gemv.cuh``), on the CPU: what of
the design can be held without the card.

- The blocks' shared memory (the warps' rings, their sums, B7's norm
  statistics, B16's row-group table) fits an H100 block (232,448 B) and
  equals the source's constants; the work plan's constants
  (``ops/decode_gemv.py``) equal the header's.
- The plan (``decode_gemv.plan``) cuts K into whole scale groups; a mirror
  of the kernels' schedule (row groups of up to 16 rows, items of (row
  group, split, 128-column tile) walked by persistent blocks, each warp a
  contiguous run of the chunk's 32-row stages; B7's gated up GEMV a quarter
  of the chunk for each of gate and up) reads every (group with
  rows, column tile, stage) once and no weight of an empty group; int4's
  stages (16 packed rows: their low and high nibbles) cover a chunk's
  logical rows once.
- A plain f32 mirror of the arithmetic (the fragments' column permutation
  undone at the store, 32-row stages, the warps' sums added in warp order,
  split partials in split order; B16: bf16(q * s) in the B operand; B7:
  each scale group's sums x . q multiplied by the group's scales, the norm
  folded into the A operand, a = act(g) * u) meets JAX: B16 against
  ``grouped_matmul`` (over the stack JAX dequantizes and casts to bf16) for
  bf16, int8 and e4m3 at 1, 2 and 16 rows within 1e-5; B7 against
  ``fused_mlp_quant_pallas(interpret=True)`` in f32 for int8, int4 and
  e4m3, gated and plain, RMSNorm, layernorm and ``apply_norm=False`` at 1,
  8 and 16 rows (16 in one pass) within 1e-5 of the output's largest
  value, and with yn and a rounded to bf16 (the kernel's A operand) the
  port's plain version within one bf16 step of the output plus one of its
  row's RMS (chip_smoke.py's QUANT_MLP_TOL). A mirror that leaves the
  fragments' permutation in place, or scales with the neighbouring group,
  misses.
- The wrappers hand the C entry points their operands, plan, partials and
  counters (a recorded fake library); B16 takes the GEMV up to GEMV_MAX_N
  rows of its format (bf16 32, int8 / e4m3 64), the wgmma forms past them.
- ``grouped_gemv_kernel`` is gone; B7's entry point reaches the new body
  and not ``quant_gemv_kernel``, which B8's rows of 8 or fewer still run.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jgg = importlib.import_module("shuffle_exchange_tpu.ops.grouped_gemm")
jfd = importlib.import_module("shuffle_exchange_tpu.ops.fused_decode")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
gg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")
fd = importlib.import_module("shuffle_exchange_tpu_torch.ops.fused_decode")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
dg = importlib.import_module("shuffle_exchange_tpu_torch.ops.decode_gemv")
CSRC = Path(gg.__file__).parent / "csrc"
SMEM_LIMIT = 232448   # dynamic shared memory an H100 block can have
SMS = 132             # the H100's SMs
E = 8
WARPS, STAGE, TILE, ROWS = 8, 32, 128, 16


def _text(name: str) -> str:
    return (CSRC / name).read_text()


def _header_constants() -> dict:
    """Every ``constexpr int NAME = <int expression>;`` of mma_gemv.cuh,
    evaluated in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) =\s*([^;]+);", _text("mma_gemv.cuh"),
                                 re.M):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, env)
    return env


def stage_bytes(fmt) -> int:
    """A stage's bytes (mma_gemv.cuh: stage_bytes): 32 rows (int4: 16
    packed rows) of a 128-column tile."""
    return 8192 if fmt == "bf16" else 2048 if fmt == 4 else 4096


# ---------------------------------------------------------------------------
# Shared memory and constants
# ---------------------------------------------------------------------------


def test_shared_memory_fits_a_block_and_matches_the_source():
    c = _header_constants()
    assert (c["kWarps"], c["kRows"], c["kTileCols"], c["kStageRows"], c["kLaneCols"]) == (
        WARPS, ROWS, TILE, STAGE, 16)
    assert (dg.WARPS, dg.PASS_ROWS, dg.TILE_COLS, dg.STAGE_ROWS) == (WARPS, ROWS, TILE, STAGE)
    ring = 16384                                   # a warp's ring
    red = WARPS * ROWS * (TILE + 16) * 4           # the warps' sums, rows padded
    stats = 2 * ROWS * 4                           # B7's mean and 1 / std a row
    bars = WARPS * 8 * 8                           # the rings' mbarriers, 8 a warp at most
    smem = 1024 + WARPS * ring + red + stats + 16 + bars   # + the swizzle's alignment slack
    assert (c["kRingBytes"], c["kRedBytes"], c["kStatBytes"], c["kBarBytes"], c["kSmemBytes"]) == (
        ring, red, stats, bars, smem)
    assert smem <= SMEM_LIMIT == c["kSmemLimit"]
    # a stage: int8 / e4m3 [32 rows][128 bytes], int4 [16 packed rows][128],
    # bf16 [32][256]; the ring's stages (and mbarriers) a warp
    assert "return FMT == kBf16 ? 8192 : FMT == kQInt4 ? 2048 : 4096;" in _text("mma_gemv.cuh")
    assert {f: ring // stage_bytes(f) for f in (8, 4, "bf16")} == {8: 4, 4: 8, "bf16": 2}
    assert max(ring // stage_bytes(f) for f in (8, 4, "bf16")) <= 8


@pytest.mark.parametrize("groups,N", [(8, 16), (8, 2), (64, 16), (8, 64), (256, 16)])
def test_b16_row_group_table_fits_beside_the_rings(groups, N):
    """B16's block keeps its row-group table after the fixed layout: 12
    bytes a row group, at most min(E, N) + N / 16 of them (the source's
    row_groups_max, the wrapper's row_groups)."""
    src = _text("grouped_gemm.cu")
    assert "return (E < N ? E : N) + N / tcg::kRows;" in src
    assert gg.row_groups(groups, N) == min(groups, N) + N // ROWS
    assert _header_constants()["kSmemBytes"] + 12 * gg.row_groups(groups, N) <= SMEM_LIMIT


# ---------------------------------------------------------------------------
# The plan and the schedule
# ---------------------------------------------------------------------------

PLAN_CASES = [(4096, 256, 112, 8, 16, 14336, 1), (14336, 256, 32, 8, 16, 4096, 1),
              (4096, 32, 112, 8, 16, 14336, 2), (14336, 32, 32, 2, 2, 4096, 2),
              (4096, 256, 224, 1, 8, 28672, 1), (14336, 256, 32, 1, 8, 4096, 0.5),
              (2048, 256, 64, 1, 8, 8192, 1), (768, 256, 24, 1, 1, 3072, 1),
              (1000, 32, 3, 8, 16, 272, 2), (64, 32, 1, 4, 3, 64, 1)]


def least_units(K, unit):
    """A chunk's fewest units: a stage for each of the 8 warps, unless K is
    shorter."""
    return min(-(-K // unit), -(-WARPS * STAGE // unit))


@pytest.mark.parametrize("K,unit,tiles,groups,rows,n_out,elt", PLAN_CASES)
def test_plan_cuts_k_into_whole_units(K, unit, tiles, groups, rows, n_out, elt):
    splits, chunk = dg.plan(K, unit, tiles, groups, rows, n_out, elt, SMS)
    assert chunk % unit == 0 and splits * chunk >= K > (splits - 1) * chunk
    assert chunk >= least_units(K, unit) * unit

    def cost(s, c):   # the stated model: the busiest SM's rounds, the partials and folds
        rounds = -(-(groups * tiles * s) // SMS)
        return rounds * (c * TILE * elt + dg.ITEM_BYTES) + (s > 1) * (
            s * rows * n_out * 8 / SMS + rounds * dg.FOLD_BYTES)
    units = -(-K // unit)
    for n in range(1, units + 1):
        per = -(-units // n)
        if per < least_units(K, unit):
            break
        assert cost(splits, chunk) <= cost(-(-K // (per * unit)), per * unit) + 1e-9


def stage_rows(fmt, unit: int, gs: int, K: int) -> np.ndarray:
    """The logical weight rows of stage ``unit`` (counted from row 0):
    int4's 16 packed rows are, in their group g, logical rows g gs + p ..
    (low nibbles) and g gs + gs / 2 + p .. (high nibbles); the others' 32
    rows from 32 unit (none past K)."""
    if fmt == 4:
        per = gs // STAGE
        g, p = divmod(unit, per)
        low = g * gs + 16 * p + np.arange(16)
        return np.concatenate([low, low + gs // 2])
    rows = unit * STAGE + np.arange(STAGE)
    return rows[rows < K]


def row_groups(sizes, N):
    """mma_gemv_grouped_kernel's table: (group, first row, rows) of up to 16
    rows of each group with rows, in group order; and the rows they hold."""
    tab, off = [], 0
    for g, size in enumerate(sizes):
        size = max(0, min(int(size), N - off))
        tab += [(g, off + r, min(ROWS, size - r)) for r in range(0, size, ROWS)]
        off += size
    return tab, off


def warp_runs(nu: int, parts: int = WARPS):
    """Each part's contiguous run [s0, s1) of a chunk's nu stages (warp w
    takes part w % parts: B7's gated up GEMV has 4 parts a matrix)."""
    return [(w * nu // parts, (w + 1) * nu // parts) for w in range(parts)]


def schedule(n_groups, tiles, splits, chunk, K, blocks):
    """(block, warp, row group, tile, stage) of every stage a warp streams:
    items (row group, split, tile), the tile fastest, block b taking items
    b, b + blocks, ..."""
    reads = []
    for b in range(blocks):
        for item in range(b, n_groups * tiles * splits, blocks):
            tile, rest = item % tiles, item // tiles
            split, grp = rest % splits, rest // splits
            k0 = split * chunk
            nu = -(-(min(K, k0 + chunk) - k0) // STAGE)
            for w, (s0, s1) in enumerate(warp_runs(nu)):
                reads += [(b, w, grp, tile, k0 // STAGE + s) for s in range(s0, s1)]
    return reads


def group_sizes(pattern: str, N: int, rng, groups: int = E) -> np.ndarray:
    """chip_smoke.group_pattern's sizes; "past_sum": N - N // 4 rows in
    groups, the last rows in none."""
    if pattern == "past_sum":
        return group_sizes("ragged", N - N // 4, rng, groups)
    if pattern == "balanced":
        sizes = np.full(groups, N // groups)
        sizes[:N % groups] += 1
    elif pattern == "one_expert":
        sizes = np.zeros(groups, np.int64)
        sizes[3] = N
    elif pattern == "empty_ends":
        sizes = np.zeros(groups, np.int64)
        sizes[1:groups - 1] = rng.multinomial(N, np.full(groups - 2, 1 / (groups - 2)))
    else:
        sizes = rng.multinomial(N, rng.dirichlet(np.ones(groups)))
    return sizes.astype(np.int32)


SCHEDULE_CASES = [(p, N, K, F, elt) for p in ("ragged", "one_expert", "empty_ends", "past_sum")
                  for N, K, F, elt in ((16, 4096, 14336, 1), (2, 14336, 4096, 1),
                                       (16, 1000, 1032, 2), (40, 256, 272, 1))]


@pytest.mark.parametrize("pattern,N,K,F,elt", SCHEDULE_CASES)
def test_b16_schedule_reads_each_weight_stage_once_and_no_empty_group(pattern, N, K, F, elt):
    rng = np.random.default_rng(N + K)
    sizes = group_sizes(pattern, N, rng)
    gs = 256 if elt == 1 and K % 256 == 0 else 8
    splits, chunk = gg.gemv_split(K, gs, F, E, N, elt, SMS)
    tiles = -(-F // TILE)
    tab, used = row_groups(sizes, N)
    assert len(tab) <= gg.row_groups(E, N) and used == min(N, int(sizes.sum()))
    blocks = dg.blocks(gg.row_groups(E, N) * tiles * splits, SMS)
    reads = schedule(len(tab), tiles, splits, chunk, K, blocks)
    units = -(-K // STAGE)
    want = {(r, t, u) for r in range(len(tab)) for t in range(tiles) for u in range(units)}
    got = [(r, t, u) for _, _, r, t, u in reads]
    assert len(got) == len(set(got)) and set(got) == want
    # a group's weights are read once a row group (once a call up to 16 rows);
    # a group with no rows has no row group
    assert {tab[r][0] for r, _, _ in got} == {g for g, s in enumerate(sizes) if s > 0
                                              and g < len(sizes)} & {g for g, _, _ in tab}
    assert all(sizes[g] > 0 for g, _, _ in tab)
    if N <= ROWS:
        assert len(tab) == int((np.minimum(np.cumsum(sizes), N) - np.concatenate(
            [[0], np.minimum(np.cumsum(sizes), N)[:-1]]) > 0).sum())
    # each warp's stages are contiguous within an item; a block's items follow
    # one another by `blocks`
    for b in range(blocks):
        assert all(w < WARPS for bb, w, *_ in reads if bb == b)


@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
@pytest.mark.parametrize("gs,K", [(32, 256), (64, 512), (256, 4096), (256, 14336)])
def test_b7_chunks_and_stages_cover_the_rows_once_in_whole_groups(fmt, gs, K):
    """Each split's chunk is whole scale groups; its stages (int4: low and
    high nibbles of 16 packed rows) cover the chunk's logical rows once,
    and a stage never spans two scale groups."""
    elt = 0.5 if fmt == 4 else 1
    for gated, n_out in ((True, 2 * 512), (False, 512)):
        splits, chunk = dg.plan(K, gs, 4, 1, 8, n_out, elt * (2 if gated else 1), SMS)
        assert chunk % gs == 0
        for s in range(splits):
            k0, k1 = s * chunk, min(K, (s + 1) * chunk)
            rows = [stage_rows(fmt, k0 // STAGE + u, gs, K) for u in range((k1 - k0) // STAGE)]
            flat = np.concatenate(rows)
            assert sorted(flat.tolist()) == list(range(k0, k1))
            assert all(len(set((r // gs).tolist())) == 1 for r in rows)


# ---------------------------------------------------------------------------
# The arithmetic
# ---------------------------------------------------------------------------

def tile_col(fmt, m: int, j: int) -> int:
    """The tile column of lane group m's j-th column (mma_gemv.cuh:
    tile_col): 16 m + j for one-byte weights (one 16-byte chunk of a
    [128]-byte box row), bf16's 8 m + j of the first 64-column box and
    64 + 8 m + j - 8 of the second."""
    if fmt == "bf16":
        return 8 * m + j if j < 8 else 64 + 8 * m + j - 8
    return 16 * m + j


def perm(fmt) -> np.ndarray:
    """perm[8 j + m]: the tile column n-tile j's slot m holds (lane group m
    supplies its B fragment's column)."""
    return np.array([tile_col(fmt, m, j) for j in range(16) for m in range(8)])


def bf16(a) -> np.ndarray:
    return torch.from_numpy(np.array(a, np.float32)).bfloat16().float().numpy()


def tile_products(A: np.ndarray, W: np.ndarray, fmt, unpermute: bool = True) -> np.ndarray:
    """A [16, k] @ W [k, 128] in f32 as the fragments hold it: n-tile j's
    slot m is tile column tile_col(m, j); the store puts it back
    (``unpermute``) or, in a broken mirror, leaves slot 8 j + m as column
    8 j + m."""
    p = perm(fmt)
    frag = (A.astype(np.float32) @ W.astype(np.float32))[:, p]
    if not unpermute:
        return frag
    out = np.empty_like(frag)
    out[:, p] = frag
    return out


def test_the_fragment_columns_are_the_sources_and_cover_the_tile_once():
    src = _text("mma_gemv.cuh")
    assert "if (FMT == kBf16) return j < 8 ? 8 * gr + j : 64 + 8 * gr + j - 8;" in src
    assert "return kLaneCols * gr + j;" in src
    for fmt in (8, "bf16"):
        assert sorted(perm(fmt).tolist()) == list(range(TILE))
    assert (perm(8) != np.arange(TILE)).any()


def gemv_tile(A, W, S, K, gs, fmt, splits, chunk, unpermute=True, shift=0, parts=WARPS):
    """One column tile over all of K: per split, each of ``parts`` warps' run of stages
    (B7, S given: the products of each scale group summed, then multiplied
    by the group's scale row S[g] (``shift``: a broken mirror's neighbour
    group) at the group's end or the run's), the warps' sums in warp
    order; the splits' in split order."""
    total = None
    per = gs // STAGE
    for s in range(splits):
        k0 = s * chunk
        nu = -(-(min(K, k0 + chunk) - k0) // STAGE)
        block = np.zeros((ROWS, TILE), np.float32)
        for s0, s1 in warp_runs(nu, parts):
            acc = np.zeros((ROWS, TILE), np.float32)
            gacc = np.zeros((ROWS, TILE), np.float32)
            for u in range(k0 // STAGE + s0, k0 // STAGE + s1):
                rows = stage_rows(fmt, u, gs, K)
                prod = tile_products(A[:, rows], W[rows], fmt, unpermute)
                if S is None:
                    acc = acc + prod
                    continue
                gacc = gacc + prod
                if u == k0 // STAGE + s1 - 1 or (u + 1) % per == 0:
                    acc = acc + S[(u // per + shift) % len(S)] * gacc
                    gacc[:] = 0
            block = block + acc
        total = block if total is None else total + block
    return total


def b16_mirror(x, wvals, sizes, splits, chunk, fmt, unpermute=True):
    """The grouped GEMV over the B operand's values ``wvals`` [E, K, F]
    (bf16(q * s) or bf16 weights) for x [N, K] (bf16 values)."""
    N, K = x.shape
    F = wvals.shape[2]
    tiles = -(-F // TILE)
    wp = np.zeros((wvals.shape[0], K, tiles * TILE), np.float32)
    wp[:, :, :F] = wvals
    out = np.zeros((N, F), np.float32)
    tab, _ = row_groups(sizes, N)
    for g, row0, rows in tab:
        A = np.zeros((ROWS, K), np.float32)
        A[:rows] = x[row0:row0 + rows]
        for t in range(tiles):
            res = gemv_tile(A, wp[g][:, t * TILE:(t + 1) * TILE], None, K, STAGE, fmt, splits,
                            chunk, unpermute)
            width = min(TILE, F - t * TILE)
            out[row0:row0 + rows, t * TILE:t * TILE + width] = res[:rows, :width]
    return out


def _b16_case(fmt, N, pattern, K=1024, F=272, gs=64):
    rng = np.random.default_rng(N * 7 + K + len(pattern) + (fmt == 8))
    sizes = group_sizes(pattern, N, rng)
    x = bf16(rng.standard_normal((N, K)))
    w = (rng.standard_normal((E, K, F)) * K ** -0.5).astype(np.float32)
    if fmt == "bf16":
        dense = bf16(w)
        return x, sizes, dense, dense, 8
    qm = jqm.quantize_weight(jnp.asarray(w), gs, bits=fmt)
    # bf16(q * s) with the product in f32: the values JAX's route dequantizes
    # and casts, and the B operand the kernel widens
    dense = bf16(np.asarray(qm.dequantize()))
    return x, sizes, dense, dense, gs


B16_CASES = [(fmt, N, p) for fmt in ("bf16", 8, "fp8") for N in (1, 2, 16)
             for p in ("ragged", "one_expert", "empty_ends")]


@pytest.mark.parametrize("fmt,N,pattern", B16_CASES)
def test_b16_mirror_matches_jax_grouped_matmul(fmt, N, pattern):
    x, sizes, dense, wvals, gs = _b16_case(fmt, N, pattern)
    K, F = x.shape[1], dense.shape[2]
    plan = gg.gemv_split(K, gs, F, E, N, 2 if fmt == "bf16" else 1, SMS)
    want = np.asarray(jgg.grouped_matmul(jnp.asarray(x), jnp.asarray(dense), jnp.asarray(sizes)))
    got = b16_mirror(x, wvals, sizes, *plan, fmt)
    assert np.abs(got - want).max() <= 1e-5 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("fmt", ["bf16", 8, "fp8"])
def test_b16_mirror_with_the_permutation_in_place_misses(fmt):
    x, sizes, dense, wvals, gs = _b16_case(fmt, 16, "ragged")
    plan = gg.gemv_split(x.shape[1], gs, dense.shape[2], E, 16, 1, SMS)
    want = np.asarray(jgg.grouped_matmul(jnp.asarray(x), jnp.asarray(dense), jnp.asarray(sizes)))
    bad = b16_mirror(x, wvals, sizes, *plan, fmt, unpermute=False)
    assert np.abs(bad - want).max() > 0.1 * np.abs(want).max()


def _act(name):
    if name in ("swiglu", "silu"):
        return lambda v: v / (1 + np.exp(-v))
    if name == "relu":
        return lambda v: np.maximum(v, 0)
    return lambda v: 0.5 * v * (1 + np.tanh(0.7978845608028654 * (v + 0.044715 * v ** 3)))


def _q_values(qm):
    """(q as exact f32 [K, N], scales [K / gs, N]) of a port QuantizedMatrix."""
    if qm.bits == 4:
        q = tqm._unpack_int4(qm.q, qm.group_size).float()
    else:
        q = qm.q.float()
    return q.numpy(), qm.scales.numpy()


def b7_mirror(resid, y, ln_w, ln_b, mats, gs, fmt, norm, activation, apply_norm, plan,
              rnd=lambda a: a, unpermute=True, shift=0, eps=1e-5):
    """B7 on the GEMV: the norm in f32 (yn rounded by ``rnd``: the
    activation dtype), the up GEMV's tiles of 64 gate beside 64 up columns
    (plain: 128 up columns), a = rnd(act(g) * u), the down GEMV, resid +
    down in f32. ``mats``: (gate or None, up, down) as (q, scales)."""
    (s1, c1), (s2, c2) = plan
    B, D = y.shape
    x = y.astype(np.float32)
    if not apply_norm:
        yn = x
    elif norm == "rmsnorm":
        yn = x * (1 / np.sqrt((x * x).mean(-1, keepdims=True) + eps)) * ln_w
    else:
        mean = x.mean(-1, keepdims=True)
        var = ((x - mean) ** 2).mean(-1, keepdims=True)
        yn = (x - mean) * (1 / np.sqrt(var + eps)) * ln_w + (0 if ln_b is None else ln_b)
    A = np.zeros((ROWS, D), np.float32)
    A[:B] = rnd(yn)
    gate, up, down = mats
    F = up[0].shape[1]
    act = _act(activation)
    a = np.zeros((ROWS, F), np.float32)
    for t in range(-(-F // TILE)):
        cols = np.arange(t * TILE, (t + 1) * TILE)
        if gate is not None:   # warps 0-3 the gate's tile, 4-7 the up matrix's
            g = gemv_tile(A, gate[0][:, cols], gate[1][:, cols], D, gs, fmt, s1, c1, unpermute,
                          shift, parts=WARPS // 2)
            u = gemv_tile(A, up[0][:, cols], up[1][:, cols], D, gs, fmt, s1, c1, unpermute,
                          shift, parts=WARPS // 2)
            a[:, cols] = act(g) * u
        else:
            res = gemv_tile(A, up[0][:, cols], up[1][:, cols], D, gs, fmt, s1, c1, unpermute,
                            shift)
            a[:, cols] = act(res)
    a = rnd(a)
    out = np.zeros((B, D), np.float32)
    for t in range(-(-D // TILE)):
        cols = np.arange(t * TILE, (t + 1) * TILE)
        res = gemv_tile(a, down[0][:, cols], down[1][:, cols], F, gs, fmt, s2, c2, unpermute,
                        shift)
        out[:, cols] = resid[:, cols] + res[:B]
    return out


B7_D, B7_F, B7_GS = 256, 512, 64
B7_FORMS = [(fmt, gated, norm) for fmt in (8, 4, "fp8") for gated in (True, False)
            for norm in ("rmsnorm", "layernorm", "none")]
B7_ACT = {8: "gelu_new", 4: "relu", "fp8": "gelu_pytorch_tanh"}   # the plain MLP's activation
_B7 = {}


def _b7_case(fmt, gated, norm, B=ROWS):
    """Inputs (bf16 values, as the kernel takes them), the storage in both
    packages and JAX's output in f32 for ROWS rows (each row's output
    depends on that row only, so fewer rows compare with its first rows)."""
    key = (fmt, gated, norm)
    if key not in _B7:
        rng = np.random.default_rng(len(_B7) + 11)
        D, F = B7_D, B7_F
        resid, y = (bf16(rng.standard_normal((ROWS, D)) + rng.standard_normal((ROWS, 1)))
                    for _ in range(2))
        ln_w = bf16(1 + 0.1 * rng.standard_normal(D))
        ln_b = bf16(0.1 * rng.standard_normal(D))
        ws = [(rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
              for s in ((D, F), (D, F), (F, D))]
        jw = [jqm.quantize_weight(jnp.asarray(w), B7_GS, bits=fmt) for w in ws]
        tw = [tqm.quantize_weight(torch.from_numpy(w), B7_GS, bits=fmt) for w in ws]
        act = "swiglu" if gated else B7_ACT[fmt]
        kw = dict(norm="layernorm" if norm == "layernorm" else "rmsnorm", eps=1e-5,
                  activation=act, apply_norm=norm != "none")
        want = np.asarray(jfd.fused_mlp_quant_pallas(
            jnp.asarray(resid), jnp.asarray(y), jnp.asarray(ln_w), jnp.asarray(ln_b), jw[1],
            jw[2], jw[0] if gated else None, interpret=True, **kw))
        _B7[key] = (resid, y, ln_w, ln_b, tw, want, kw)
    resid, y, ln_w, ln_b, tw, want, kw = _B7[key]
    return resid[:B], y[:B], ln_w, ln_b, tw, want[:B], kw


def _b7_run(fmt, gated, norm, B, **mirror_kw):
    resid, y, ln_w, ln_b, tw, want, kw = _b7_case(fmt, gated, norm, B)
    mats = (_q_values(tw[0]) if gated else None, _q_values(tw[1]), _q_values(tw[2]))
    up, down = fd.mlp_quant_plan(B7_D, B7_F, B7_GS, gated, B, 0.5 if fmt == 4 else 1, SMS)
    got = b7_mirror(resid, y, ln_w, ln_b if kw["norm"] == "layernorm" else None, mats, B7_GS,
                    fmt, kw["norm"], kw["activation"], kw["apply_norm"], (up[:2], down[:2]),
                    **mirror_kw)
    return got, want, (resid, y, ln_w, ln_b, tw, kw)


@pytest.mark.parametrize("B", [1, 8, 16])
@pytest.mark.parametrize("fmt,gated,norm", B7_FORMS)
def test_b7_mirror_matches_the_pallas_kernel(fmt, gated, norm, B):
    got, want, _ = _b7_run(fmt, gated, norm, B)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("fmt,gated,norm", [(8, True, "rmsnorm"), (4, False, "layernorm"),
                                            ("fp8", True, "none")])
def test_b7_bf16_mirror_is_within_one_step_of_the_plain_version(fmt, gated, norm):
    """With yn and a rounded to bf16 (the A operand the kernel feeds the
    tensor cores) the mirror sits within QUANT_MLP_TOL of the port's plain
    version in bf16 at 16 rows (one pass)."""
    got, _, (resid, y, ln_w, ln_b, tw, kw) = _b7_run(fmt, gated, norm, ROWS, rnd=bf16)
    tb = lambda a: torch.from_numpy(a).bfloat16()
    qs = [m.to(None, torch.bfloat16) for m in tw]
    want = fd.fused_mlp_quant_reference(
        tb(resid), tb(y), tb(ln_w), qs[1], qs[2], qs[0] if gated else None, kw["eps"],
        ln_b=tb(ln_b) if kw["norm"] == "layernorm" else None, norm=kw["norm"],
        activation=kw["activation"], apply_norm=kw["apply_norm"]).float().numpy()
    got = bf16(got)
    rms = np.sqrt((want ** 2).mean(-1, keepdims=True))
    assert (np.abs(got - want) <= 2 ** -7 * np.abs(want) + 2 ** -7 * rms).all()


@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
@pytest.mark.parametrize("bite", ["permutation_in_place", "neighbour_group_scales"])
def test_b7_broken_mirrors_miss(fmt, bite):
    kw = dict(unpermute=False) if bite == "permutation_in_place" else dict(shift=1)
    bad, want, _ = _b7_run(fmt, True, "rmsnorm", 8, **kw)
    assert np.abs(bad - want).max() > 0.05 * np.abs(want).max()


# ---------------------------------------------------------------------------
# The wrappers' C arguments
# ---------------------------------------------------------------------------


class _Lib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def fn(*args):
            self.calls[name] = args
            return 0
        return fn


@pytest.fixture
def recorded(monkeypatch):
    calls = {}
    for mod in (gg, fd):
        monkeypatch.setattr(mod, "_lib", lambda: _Lib(calls))
        monkeypatch.setattr(mod, "_sms", lambda dev: SMS)
    monkeypatch.setattr(fd, "_COUNTERS", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    # B7's operand checks want CUDA tensors; these are CPU stand-ins
    monkeypatch.setattr(fd, "_bf16", lambda name, t, device, shape=None: t)
    monkeypatch.setattr(fd, "_vector", lambda name, t, device, n: t)
    return calls


@pytest.mark.parametrize("fmt", ["bf16", 8, "fp8"])
@pytest.mark.parametrize("N", [1, 2, 16, 32])
def test_b16_wrapper_hands_the_gemv_its_plan_partials_and_counters(recorded, fmt, N):
    K, F = 1024, 272
    w = torch.zeros(E, K, F, dtype=torch.bfloat16)
    gs = 8
    if fmt != "bf16":
        w = tqm.quantize_weight(torch.randn(E, K, F), 64, bits=fmt).to(None, torch.bfloat16)
        gs = 64
    x = torch.zeros(N, K, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("ragged", N, np.random.default_rng(N)))
    out = gg._launch(x, w, sizes)
    args = recorded.pop("sxt_grouped_matmul_bf16")
    assert not recorded and len(args) == 18 and out.shape == (N, F)
    wp = w.data_ptr() if fmt == "bf16" else w.q.data_ptr()
    sp = None if fmt == "bf16" else w.scales.data_ptr()
    assert args[:5] == (x.data_ptr(), wp, sp, sizes.data_ptr(), out.data_ptr())
    assert args[6:12] == (N, K, F, E, gs, gg.FORMATS[fmt])
    splits, chunk = gg.gemv_split(K, gs, F, E, N, 2 if fmt == "bf16" else 1, SMS)
    assert args[12:14] == (splits, chunk)
    tiles = -(-F // TILE)
    assert args[15:17] == (dg.blocks(gg.row_groups(E, N) * tiles * splits, SMS),
                           gg.GEMV_MAX_N[fmt])
    assert args[17] == 7
    if splits == 1:
        assert args[5] is None and args[14] is None
    else:
        counters = fd._COUNTERS[(x.device, 7)]
        assert args[14] == counters.data_ptr() and not counters.any()
        assert counters.numel() >= gg.row_groups(E, N) * tiles


@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("B", [1, 9, 16, 20])
def test_b7_wrapper_hands_the_entry_point_its_plan_and_workspaces(recorded, monkeypatch, fmt,
                                                                  gated, B):
    made = {}
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        made[t.data_ptr()] = (tuple(t.shape), t.dtype)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    D, F, gs = 512, 1024, 64
    ws = [tqm.quantize_weight(torch.randn(*s), gs, bits=fmt).to(None, torch.bfloat16)
          for s in ((D, F), (D, F), (F, D))]
    h = torch.zeros(B, D, dtype=torch.bfloat16)
    ln_w = torch.ones(D, dtype=torch.bfloat16)
    out = fd._launch_mlp_quant(h, h, ln_w, ws[1], ws[2], ws[0] if gated else None, 1e-5,
                               ln_b=None, norm="rmsnorm", activation="swiglu" if gated else "relu")
    args = recorded.pop("sxt_fused_mlp_quant_bf16")
    assert not recorded and len(args) == len(fd._SIGNATURES["sxt_fused_mlp_quant_bf16"])
    assert out.shape == h.shape
    gate = (ws[0].q.data_ptr(), ws[0].scales.data_ptr()) if gated else (None, None)
    assert args[:10] == (h.data_ptr(), h.data_ptr(), ln_w.data_ptr(), None, *gate,
                         ws[1].q.data_ptr(), ws[1].scales.data_ptr(), ws[2].q.data_ptr(),
                         ws[2].scales.data_ptr())
    rows = min(B, ROWS)
    (s1, c1, b1), (s2, c2, b2) = fd.mlp_quant_plan(D, F, gs, gated, rows,
                                                   0.5 if fmt == 4 else 1, SMS)
    assert args[15:] == (B, D, F, gs, tqm.FORMATS[fmt], s1, c1, s2, c2, b1, b2, 0,
                         0 if gated else 1, 1e-5, 7)
    assert args[10] == out.data_ptr() and made[args[11]] == ((rows, F), torch.bfloat16)
    assert (args[12] is None) == (s1 == 1) and (args[13] is None) == (s2 == 1)
    if s1 > 1:
        assert made[args[12]] == ((s1, rows, (2 if gated else 1) * F), torch.float32)
    if s2 > 1:
        assert made[args[13]] == ((s2, rows, D), torch.float32)
    if s1 > 1 or s2 > 1:
        counters = fd._COUNTERS[(h.device, 7)]
        assert args[14] == counters.data_ptr() and not counters.any()
        assert counters.numel() >= max(-(-F // TILE), -(-D // TILE))
    else:
        assert args[14] is None


# ---------------------------------------------------------------------------
# The replaced kernels
# ---------------------------------------------------------------------------


def test_the_replaced_gemvs_are_gone_and_b8_keeps_its_own():
    sources = {p.name: p.read_text() for p in CSRC.iterdir()}
    assert not any("grouped_gemv_kernel" in t or "grouped_out_kernel" in t
                   for t in sources.values())
    fused = sources["fused_decode.cu"]
    entry = fused.split("int sxt_fused_mlp_quant_bf16(", 1)[1]
    assert "quant_gemv_kernel" not in fused and "launch_quant_gemv" not in fused
    assert "mlp_quant_pass<" in entry and "tcg::run<FMT, false, true>" in fused
    grouped = sources["grouped_gemm.cu"]
    assert "launch_decode_gemv<" in grouped and "tcg::run<FMT, FMT != tcg::kBf16, false>" in grouped
    # B8's rows of 8 or fewer keep the CUDA-core GEMV of quant_gemv.cuh
    assert "launch_quant_gemv<true>" in sources["quant_matmul.cu"]
    assert tqm.GEMV_ROWS == 8
    py = Path(gg.__file__).read_text() + Path(fd.__file__).read_text()
    assert "GEMV_CHUNK = 1024    # reduction rows per GEMV block" not in Path(gg.__file__).read_text()
    assert "quant_splits" not in Path(fd.__file__).read_text() and "environ" not in py


@pytest.mark.parametrize("fmt,N,gemv", [("bf16", 32, True), ("bf16", 33, False), (8, 64, True),
                                        (8, 65, False), ("fp8", 64, True), ("fp8", 65, False)])
def test_b16_routes_by_the_format_s_gemv_rows(recorded, fmt, N, gemv):
    """The GEMV takes up to GEMV_MAX_N rows of its format (bf16 32, int8 /
    e4m3 64: where it beat the wgmma forms on the H100), the wgmma forms
    the rest (one split over K, no partials, no blocks)."""
    assert gg.GEMV_MAX_N == {"bf16": 32, 8: 64, "fp8": 64}
    K, F = 512, 272
    w = torch.zeros(E, K, F, dtype=torch.bfloat16)
    if fmt != "bf16":
        w = tqm.quantize_weight(torch.randn(E, K, F), 64, bits=fmt).to(None, torch.bfloat16)
    x = torch.zeros(N, K, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("ragged", N, np.random.default_rng(N)))
    gg._launch(x, w, sizes)
    args = recorded.pop("sxt_grouped_matmul_bf16")
    assert args[16] == gg.GEMV_MAX_N[fmt] and (N <= args[16]) == gemv
    if not gemv:
        assert args[12:16] == (1, K, None, 0) and args[5] is None
