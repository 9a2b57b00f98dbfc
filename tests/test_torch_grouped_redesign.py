"""B16's grouped GEMM redesigned for Hopper (the bf16 ``gmm``, forward and
dx, and the ``tgmm`` for dw as warp-specialised ``wgmma`` kernels over
TMA-fed tiles, ``ops/csrc/grouped_gemm.cu``), on the CPU: what of their
design can be held without the card.

- Each instance's shared memory, from a mirror of the launchers' formula
  (``wgmma_smem_bytes``), fits an H100 block (232,448 B) and equals the
  CUDA source's (the ``WgGemm`` struct's expressions evaluated), and so do
  the tile shapes, the raster's band and the staging row it mirrors.
- A mirror of the ``gmm`` block schedule (``find_tile`` and the band
  raster) covers every (output row, column tile) exactly once, never stores
  a row outside its block's group (rows past the groups' sum are zero
  tiles), and keeps each wave of 132 blocks inside patches of 16 row tiles
  by a few column tiles; over the chip smoke test's group patterns (balanced, one_expert,
  empty_ends, ragged, past_sum), at row counts that are not multiples of
  the tile, and K, F that are not multiples of it (1000 x 1032).
- A mirror of the ``tgmm`` walk visits each (group, K tile, F tile) once,
  largest group first, walks the group's rows in order from its first row,
  and zeroes exactly the rows past the group on the walk's last step.
- A plain f32 mirror of both tiled computations (64-row reduction steps
  over zero-filled boxes, the boxes reaching into the next group's rows)
  equals the JAX package's ``grouped_matmul`` (``jax.lax.ragged_dot`` on
  the CPU) and its ``jax.vjp`` within 1e-5; without the zeroing the dw
  mirror misses it.
- The wrappers hand the C entry points their operands, shapes and form (dx
  is the transposed product's own entry point), and refuse a base that is
  not 16-byte aligned, naming the shape.
- The quantized forward (``wg_qgmm_kernel``: a 256 x 128 gmm block over
  weight tiles that the producer's warps widen to bf16 in shared memory):
  its shared memory against the source's ``WgQGemm`` and 232,448 B, no
  register reallocation; the widening (int8 through the exact 2^23 + b
  path, e4m3 through fp8_to_float's conversion) equal to bf16(q * s) for
  every byte; the widening warps writing each element of a step's
  swizzled tile once, each K row with its own scale row; and a plain f32
  mirror of the tiled arithmetic (64-row steps, at most two scale rows a
  step, bf16(q * s), 16-row k-steps) against JAX ``grouped_matmul`` over
  int8 and e4m3 ``QuantizedMatrix`` stacks at group sizes 32, 64, 96 and
  256 in the four group patterns, within 1e-5; a mirror that reads only
  the step's first scale row misses it at group size 32.
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jgg = importlib.import_module("shuffle_exchange_tpu.ops.grouped_gemm")
jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
gg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
CU = (gg.__file__.rsplit("/", 1)[0]) + "/csrc/grouped_gemm.cu"
QGEMM = (gg.__file__.rsplit("/", 1)[0]) + "/csrc/wgmma_qgemm.cuh"
SMEM_LIMIT = 232448   # dynamic shared memory an H100 block can have
SMS = 132             # the H100's SMs: one block each (the blocks' shared memory)
# the kernels' block: a BM x BN output tile (tgmm: BM of K, BN of F), two
# consumers of 64 rows, reduction steps of BK, a ring of STAGES stages
TILE = dict(BM=128, BN=256, BK=64, STAGES=4)
BAND = 16             # row tiles a band of the raster
STAGE_LD = 144        # bytes a row of a consumer's epilogue staging tile
WG_ROWS = 64          # rows a consumer warpgroup
E = 8


def wgmma_smem_bytes(which: str, groups: int = E) -> int:
    """Dynamic shared memory of one block of ``which`` ("gmm" for the
    forward and dx, "tgmm" for dw), as its launcher asks for it: the
    alignment slack, the ring of (A tile [BM][BK], B tile [BK][BN]) stages,
    the two consumers' [64][64] bf16 staging tiles (rows STAGE_LD bytes
    apart), the ring's mbarriers (full and empty a stage, 8 bytes each) and,
    for tgmm, the block's group (4 bytes) and each group's first row and
    size (8 bytes a group)."""
    bm, bn, bk, stages = TILE["BM"], TILE["BN"], TILE["BK"], TILE["STAGES"]
    smem = 1024 + stages * (bm * bk + bk * bn) * 2 + 2 * WG_ROWS * STAGE_LD + 8 * 2 * stages
    return smem + (4 + 8 * groups if which == "tgmm" else 0)


def _source() -> str:
    """grouped_gemm.cu with the header whose block it shares with B8
    (``wgmma_qgemm.cuh``: the block layout, raster, epilogue and the
    quantized form's ``qgemm_tile``)."""
    return open(CU).read() + open(QGEMM).read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)[;,]", _source()).group(1))


def _source_tiles() -> dict:
    """The constants of the CUDA source's ``WgGemm``, each evaluated from
    its C expression in order."""
    body = _source().split("struct WgGemm {", 1)[1].split("};", 1)[0]
    env = {name: _constant(name) for name in ("kAlign", "kConsumerWgs", "kStageLd",
                                              "kSmemLimit")}
    for decl in re.findall(r"static constexpr (?:int|bool) ([^;]+);", body):
        for name, expr in re.findall(r"(\w+) =\s*((?:[^,(]|\([^)]*\))+)", decl):
            env[name] = eval(" ".join(expr.split()), {}, env)
    return env


# ---------------------------------------------------------------------------
# Shared memory and tile shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["gmm", "tgmm"])
def test_shared_memory_fits_a_block_and_matches_the_source(which):
    src = _source_tiles()
    assert {k: src[k] for k in TILE} == TILE
    assert (_constant("kBand"), _constant("kStageLd"), src["kConsumerWgs"]) == (BAND, STAGE_LD, 2)
    assert src["BM"] == src["kConsumerWgs"] * WG_ROWS and src["BK"] == 64
    smem = wgmma_smem_bytes(which)
    assert smem <= SMEM_LIMIT == src["kSmemLimit"]
    launcher = src["SMEM"] + (src["RANK_BYTES"] + src["GROUP_BYTES"] * E if which == "tgmm"
                              else 0)
    assert launcher == smem
    # a stage is 48 KB: a [128][64] and a [64][256] bf16 tile
    assert src["STAGE_BYTES"] == 48 * 1024 and src["STAGES"] * src["STAGE_BYTES"] == 196608
    # the staging rows are 16 bytes past a 128-byte row: the fragments'
    # bf16 pairs (rows lane / 4, columns 2 (lane % 4)) land in 32 banks
    banks = {((lane // 4) * STAGE_LD + (lane % 4) * 4) // 4 % 32 for lane in range(32)}
    assert len(banks) == 32 and STAGE_LD % 16 == 0


def test_tgmm_group_table_limit_fits_and_is_checked():
    src = _source_tiles()
    most = src["MAX_GROUPS"]
    assert wgmma_smem_bytes("tgmm", most) <= SMEM_LIMIT < wgmma_smem_bytes("tgmm", most + 1)
    assert "E > Sh::MAX_GROUPS" in _source()


# ---------------------------------------------------------------------------
# Group patterns (the chip smoke test's phases 2f / 2h)
# ---------------------------------------------------------------------------

PATTERNS = ("balanced", "one_expert", "empty_ends", "ragged", "past_sum")


def group_sizes(pattern: str, N: int, rng, groups: int = E) -> np.ndarray:
    """``chip_smoke.group_pattern``'s sizes; "past_sum": a ragged spread of
    N - 100 rows (the last rows belong to no group)."""
    if pattern == "past_sum":
        return group_sizes("ragged", N - min(100, N // 2), rng, groups)
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


# ---------------------------------------------------------------------------
# The gmm block schedule
# ---------------------------------------------------------------------------


def find_tile(sizes, N, tile_rows, y):
    """``find_tile``: (row0, rows, group) of row slot y; group -1: rows past
    the groups' sum, -2: no tile."""
    off = 0
    for g, raw in enumerate(sizes):
        size = max(0, min(int(raw), N - off))
        tiles = -(-size // tile_rows)
        if y < tiles:
            return off + y * tile_rows, min(tile_rows, size - y * tile_rows), g
        y -= tiles
        off += size
    size = N - off
    tiles = -(-size // tile_rows)
    if y < tiles:
        return off + y * tile_rows, min(tile_rows, size - y * tile_rows), -1
    return 0, 0, -2


def raster(b, slots, col_tiles, band=BAND):
    """The kernels' ``raster``: block b -> (row slot, column tile)."""
    band_i, r = divmod(b, band * col_tiles)
    width = min(band, slots - band_i * band)
    return band_i * band + r % width, r // width


def gmm_blocks(sizes, N, C, bm=TILE["BM"], bn=TILE["BN"]):
    """The gmm launch: (row slot, column tile, (row0, rows, group)) of
    every block in issue order; C is the output width (F; dx: K), the
    tiles bm x bn (the quantized forward's tall tile: 256 x 128)."""
    slots, col_tiles = -(-N // bm) + len(sizes), -(-C // bn)
    out = []
    for b in range(slots * col_tiles):
        y, c = raster(b, slots, col_tiles)
        out.append((y, c, find_tile(sizes, N, bm, y)))
    return out


def _group_of_rows(sizes, N):
    owner = np.full(N, -1)
    off = 0
    for g, raw in enumerate(sizes):
        size = max(0, min(int(raw), N - off))
        owner[off:off + size] = g
        off += size
    return owner


GMM_CASES = [(pattern, N, K, F) for pattern in PATTERNS
             for N, K, F in ((512, 4096, 14336), (16384, 4096, 14336), (1000, 1000, 1032),
                             (17, 1024, 2816))]


@pytest.mark.parametrize("pattern,N,K,F", GMM_CASES)
def test_gmm_blocks_store_every_row_and_column_tile_once_inside_their_group(pattern, N, K, F):
    sizes = group_sizes(pattern, N, np.random.default_rng(N + K))
    owner = _group_of_rows(sizes, N)
    for C in (F, K):    # the forward's output columns, then dx's
        col_tiles = -(-C // TILE["BN"])
        stored = np.zeros((N, col_tiles), np.int64)
        seen = set()
        for y, c, (row0, rows, g) in gmm_blocks(sizes, N, C):
            assert (y, c) not in seen
            seen.add((y, c))
            if g == -2:
                continue
            assert 0 < rows <= TILE["BM"]
            # every stored row belongs to the block's group (-1: past the sum)
            assert (owner[row0:row0 + rows] == g).all()
            stored[row0:row0 + rows, c] += 1
        assert (stored == 1).all()
        # an empty group has no tile
        used = {g for _, _, (_, _, g) in gmm_blocks(sizes, N, C) if g >= 0}
        assert used == {g for g in range(E) if sizes[g] > 0}


@pytest.mark.parametrize("N,C", [(16384, 14336), (16384, 4096), (81840, 1024), (512, 14336)])
def test_gmm_raster_keeps_a_wave_inside_a_band_patch(N, C):
    """Any 132 consecutive blocks (a wave, one block an SM) lie in as few
    bands as 132 blocks can fill, plus one, and their part in a band of w row
    slots covers those slots and at most ceil(part / w) + 1 column tiles:
    each weight panel the wave reads is shared by up to 16 row tiles."""
    sizes = group_sizes("ragged", N, np.random.default_rng(1))
    blocks = gmm_blocks(sizes, N, C)
    slots, col_tiles = -(-N // TILE["BM"]) + E, -(-C // TILE["BN"])
    for w0 in range(0, max(1, len(blocks) - SMS + 1), 37):
        wave = blocks[w0:w0 + SMS]
        bands = {}
        for y, c, _ in wave:
            bands.setdefault(y // BAND, []).append((y, c))
        assert len(bands) <= -(-SMS // (BAND * col_tiles)) + 1
        for band, part in bands.items():
            width = min(BAND, slots - band * BAND)
            assert len({y for y, _ in part}) <= width
            assert len({c for _, c in part}) <= -(-len(part) // width) + 1


# ---------------------------------------------------------------------------
# The tgmm walk
# ---------------------------------------------------------------------------


def rank_order(sizes, N):
    """Groups by clamped size, largest first, ties by index (the blocks'
    ``blockIdx.y``)."""
    clamped, off = [], 0
    for raw in sizes:
        size = max(0, min(int(raw), N - off))
        clamped.append((off, size))
        off += size
    order = sorted(range(len(sizes)), key=lambda g: (-clamped[g][1], g))
    return order, clamped


def tgmm_blocks(sizes, N, K, F):
    """(group, k0, f0, [(box row, valid rows), ...]) of every tgmm block in
    issue order: blockIdx.y ranks the group, blockIdx.x is its tile by the
    raster (K tiles as the row slots); the walk's boxes of 64 rows start at
    the group's first row."""
    order, clamped = rank_order(sizes, N)
    k_tiles, f_tiles = -(-K // TILE["BM"]), -(-F // TILE["BN"])
    out = []
    for z in range(len(sizes)):
        g = order[z]
        off, size = clamped[g]
        for b in range(k_tiles * f_tiles):
            kt, ft = raster(b, k_tiles, f_tiles)
            walk = [(row, min(TILE["BK"], off + size - row))
                    for row in range(off, off + size, TILE["BK"])]
            out.append((g, kt * TILE["BM"], ft * TILE["BN"], walk))
    return out


@pytest.mark.parametrize("pattern,N,K,F", [(p, N, K, F) for p in PATTERNS
                                           for N, K, F in ((65472, 1024, 2816), (4100, 1000, 1032),
                                                           (16, 1024, 2816))])
def test_tgmm_walk_visits_each_tile_once_in_row_order_zeroing_past_the_group(pattern, N, K, F):
    sizes = group_sizes(pattern, N, np.random.default_rng(N + F))
    owner = _group_of_rows(sizes, N)
    blocks = tgmm_blocks(sizes, N, K, F)
    keys = [(g, k0, f0) for g, k0, f0, _ in blocks]
    assert sorted(keys) == sorted((g, k, f) for g in range(E) for k in range(0, K, TILE["BM"])
                                  for f in range(0, F, TILE["BN"]))
    assert len(set(keys)) == len(keys)
    # the groups go largest first
    firsts = [g for i, (g, *_rest) in enumerate(blocks) if i == 0 or blocks[i - 1][0] != g]
    assert [int(sizes[g]) for g in firsts] == sorted((int(s) for s in sizes), reverse=True)
    for g, _, _, walk in blocks:
        rows = [r for row, valid in walk for r in range(row, row + valid)]
        assert rows == list(np.flatnonzero(owner == g))      # in order, each once
        for i, (row, valid) in enumerate(walk):
            box = np.arange(row, row + TILE["BK"])
            zeroed = box[valid:]
            # only the last step zeroes, exactly the box's rows outside the group
            assert (valid < TILE["BK"]) == (i == len(walk) - 1 and len(rows) % TILE["BK"] != 0)
            assert ((owner[box[box < N]] == g) == (box[box < N] < row + valid)).all()
            assert (zeroed >= row + valid).all()
        if not walk:
            assert sizes[g] == 0 or owner.tolist().count(g) == 0


# ---------------------------------------------------------------------------
# Plain f32 mirrors of the tiled arithmetic against JAX
# ---------------------------------------------------------------------------


def _box(a, row0, rows=TILE["BM"]):
    """Rows [row0, row0 + rows) of a 2-D array, zeros past its end (TMA's)."""
    out = np.zeros((rows, a.shape[1]), np.float32)
    take = a[row0:row0 + rows]
    out[:len(take)] = take
    return out


def gmm_mirror(a, w, sizes, trans):
    """The gmm kernel's arithmetic: per block, the tile's 128 rows of a
    (reaching past a short tile into the next group's rows), 64-row
    reduction steps of f32 products added in order, zero-filled past the
    reduction's end; only the tile's own rows stored."""
    N = a.shape[0]
    _, K, F = w.shape
    R, C = (F, K) if trans else (K, F)
    out = np.full((N, C), np.nan, np.float32)
    for _, c, (row0, rows, g) in gmm_blocks(sizes, N, C):
        if g == -2:
            continue
        c0, c1 = c * TILE["BN"], min(C, (c + 1) * TILE["BN"])
        if g == -1:
            out[row0:row0 + rows, c0:c1] = 0
            continue
        A = _box(a, row0)
        B = w[g].T if trans else w[g]                    # [R, C]
        acc = np.zeros((TILE["BM"], c1 - c0), np.float32)
        for r0 in range(0, R, TILE["BK"]):
            acc += A[:, r0:r0 + TILE["BK"]] @ B[r0:r0 + TILE["BK"], c0:c1]
        out[row0:row0 + rows, c0:c1] = acc[:rows]
    assert not np.isnan(out).any()
    return out


def tgmm_mirror(x, dout, sizes, zero_past_group=True):
    """The tgmm kernel's arithmetic: per (group, K tile, F tile), the walk's
    64-row boxes of x and dout from the group's first row, the rows past
    the group zeroed on the last step, x_box^T dout_box added in order."""
    N, K = x.shape
    F = dout.shape[1]
    out = np.full((len(sizes), K, F), np.nan, np.float32)
    for g, k0, f0, walk in tgmm_blocks(sizes, N, K, F):
        k1, f1 = min(K, k0 + TILE["BM"]), min(F, f0 + TILE["BN"])
        acc = np.zeros((k1 - k0, f1 - f0), np.float32)
        for row, valid in walk:
            xa, da = _box(x, row, TILE["BK"])[:, k0:k1], _box(dout, row, TILE["BK"])[:, f0:f1]
            if zero_past_group:
                xa[valid:], da[valid:] = 0, 0
            acc += xa.T @ da
        out[g, k0:k1, f0:f1] = acc
    assert not np.isnan(out).any()
    return out


def _jax_vjp(x, w, sizes, dout):
    out, vjp = jax.vjp(lambda a, b: jgg.grouped_matmul(a, b, jnp.asarray(sizes)),
                       jnp.asarray(x), jnp.asarray(w))
    dx, dw = vjp(jnp.asarray(dout))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)


def _close(got, want, what):
    err = np.abs(got - want).max()
    assert err <= 1e-5, f"{what}: max abs err {err}"


MIRROR_CASES = [(p, N, K, F) for p in PATTERNS for N, K, F in ((300, 136, 264), (40, 64, 72))] + \
               [("ragged", 600, 200, 520)]


@pytest.mark.parametrize("pattern,N,K,F", MIRROR_CASES)
def test_tiled_mirrors_match_jax_grouped_matmul_and_its_vjp(pattern, N, K, F):
    rng = np.random.default_rng(N * 3 + F)
    sizes = group_sizes(pattern, N, rng, groups=4)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = (rng.standard_normal((4, K, F)) * K ** -0.5).astype(np.float32)
    dout = rng.standard_normal((N, F)).astype(np.float32) * F ** -0.5
    out, jdx, jdw = _jax_vjp(x, w, sizes, dout)
    _close(gmm_mirror(x, w, sizes, trans=False), out, "forward")
    _close(gmm_mirror(dout, w, sizes, trans=True), jdx, "dx")
    _close(tgmm_mirror(x, dout, sizes), jdw, "dw")
    if sizes.sum() < N:
        assert not gmm_mirror(dout, w, sizes, trans=True)[sizes.sum():].any()
    # and the port's plain versions agree with the mirrors
    T = torch.from_numpy
    _close(gg.grouped_matmul_reference(T(x), T(w), T(sizes)).numpy(), out, "plain forward")
    _close(gg.grouped_matmul_dw_reference(T(x), T(dout), T(sizes)).numpy(), jdw, "plain dw")


@pytest.mark.parametrize("pattern", ["balanced", "ragged", "past_sum"])
def test_tgmm_without_zeroing_the_rows_past_the_group_misses_jax(pattern):
    rng = np.random.default_rng(7)
    N, K, F = 300, 136, 264
    sizes = group_sizes(pattern, N, rng, groups=4)
    x = rng.standard_normal((N, K)).astype(np.float32)
    dout = rng.standard_normal((N, F)).astype(np.float32)
    _, _, jdw = _jax_vjp(x, np.zeros((4, K, F), np.float32), sizes, dout)
    assert np.abs(tgmm_mirror(x, dout, sizes, zero_past_group=False) - jdw).max() > 1e-2


# ---------------------------------------------------------------------------
# The C arguments
# ---------------------------------------------------------------------------


class _Lib:   # records each C call's arguments
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.fixture
def recorded(monkeypatch):
    calls = {}
    monkeypatch.setattr(gg, "_lib", lambda: _Lib(calls))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    return calls


@pytest.mark.parametrize("N", [33, 300])
def test_wrappers_hand_the_c_entry_points_operands_shapes_and_form(recorded, N):
    K, F = 136, 264
    x = torch.zeros(N, K, dtype=torch.bfloat16)
    w = torch.zeros(E, K, F, dtype=torch.bfloat16)
    dout = torch.zeros(N, F, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("ragged", N, np.random.default_rng(0)))
    out = gg._launch(x, w, sizes)
    args = recorded.pop("sxt_grouped_matmul_bf16")
    # x, w, no scales, sizes, out, no partials (past GEMV_MAX_N's 32 bf16 rows:
    # the wgmma kernel), the shapes, bf16 (code 3), one split over K
    assert args[:6] == (x.data_ptr(), w.data_ptr(), None, sizes.data_ptr(), out.data_ptr(), None)
    assert args[6:14] == (N, K, F, E, 8, gg.FORMATS["bf16"], 1, K)
    assert out.shape == (N, F) and out.dtype == torch.bfloat16
    dx = gg._launch_dx(dout, w, sizes)
    assert recorded.pop("sxt_grouped_matmul_dx_bf16")[:8] == (
        dout.data_ptr(), w.data_ptr(), sizes.data_ptr(), dx.data_ptr(), N, K, F, E)
    assert dx.shape == (N, K)
    dw = gg._launch_dw(x, dout, sizes)
    assert recorded.pop("sxt_grouped_matmul_dw_bf16")[:8] == (
        x.data_ptr(), dout.data_ptr(), sizes.data_ptr(), dw.data_ptr(), N, K, F, E)
    assert dw.shape == (E, K, F)
    assert not recorded


def test_wrappers_refuse_an_unaligned_base_naming_the_shape(recorded):
    N, K, F = 40, 64, 72
    flat = torch.zeros(N * K + 1, dtype=torch.bfloat16)
    x = flat[1:].view(N, K)                                     # 2 bytes off
    dout = torch.zeros(N * F + 1, dtype=torch.bfloat16)[1:].view(N, F)
    w = torch.zeros(E, K, F, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("balanced", N, np.random.default_rng(0)))
    with pytest.raises(ValueError, match=r"x \(40, 64\) must start on a 16-byte"):
        gg._launch(x, w, sizes)
    with pytest.raises(ValueError, match=r"dout \(40, 72\) must start on a 16-byte"):
        gg._launch_dx(dout, w, sizes)
    with pytest.raises(ValueError, match=r"x \(40, 64\) must start on a 16-byte"):
        gg._launch_dw(x, dout.contiguous(), sizes)
    assert not recorded
    # a strided view is copied, not refused
    gg._launch_dw(torch.zeros(K, N, dtype=torch.bfloat16).T, torch.zeros(N, F,
                  dtype=torch.bfloat16), sizes)
    assert "sxt_grouped_matmul_dw_bf16" in recorded


def test_the_replaced_kernels_are_gone_and_nothing_switches_back():
    src = _source()
    for gone in ("grouped_dx_kernel", "grouped_dw_kernel", "DxStage", "DwStage",
                 "grouped_mma_kernel", "launch_mma", "struct Stage", "load_step", "mma_sync.cuh",
                 "ldsm_x4", "cp_async"):
        assert gone not in src
    # the quantized wgmma form is built for int8 and e4m3 only, and both
    # quantized formats past 16 rows route to it
    assert 'static_assert(FMT == kQInt8 || FMT == kQFp8, "bf16 weights take wg_gmm_kernel")' in src
    assert "launch_qgmm<kQInt8>" in src and "launch_qgmm<kQFp8>" in src
    assert "launch_gmm<false>" in src and "launch_gmm<true>" in src
    py = open(gg.__file__).read()
    assert "environ" not in py and "getenv" not in py


# ---------------------------------------------------------------------------
# The quantized forward: wg_qgmm_kernel's widened tiles
# ---------------------------------------------------------------------------

# the quantized forward's tile (BM, BN): tall, so that each widened step
# feeds 256 rows of products
QTILE = (256, 128)
QSLOTS, QRAW, SC_ROWS = 3, 6, 2   # widened slots, raw stages, scale rows a raw stage


def qgmm_smem_bytes(slots=QSLOTS, raw=QRAW) -> int:
    """The quantized forward's dynamic shared memory: the alignment slack,
    ``slots`` widened slots (x's [BM][64] bf16 tile and the [64][BN] bf16 B
    tile), ``raw`` raw stages (the one-byte [64][BN] weight tile and two
    f32 scale rows of BN), the two consumers' epilogue staging tiles and
    the two rings' mbarriers."""
    bm, bn = QTILE
    stage = (bm * 64 + 64 * bn) * 2
    raw_stage = 64 * bn + SC_ROWS * bn * 4
    return 1024 + slots * stage + raw * raw_stage + 2 * WG_ROWS * STAGE_LD + 8 * 2 * (slots + raw)


def _source_qtiles() -> dict:
    """``WgQGemm``'s constants, its ``WgGemm::`` terms taken from
    ``WgGemm``'s evaluated constants."""
    body = _source().split("struct WgQGemm {", 1)[1].split("};", 1)[0]
    env = dict(_source_tiles())
    for decl in re.findall(r"static constexpr (?:int|bool) ([^;]+);", body):
        for name, expr in re.findall(r"(\w+) =\s*((?:[^,(]|\([^)]*\))+)", decl):
            expr = " ".join(expr.replace("WgGemm::", "").split())
            env[name] = eval(expr.replace("/", "//"), {}, env)
    return env


def test_quantized_block_fits_shared_memory_and_the_register_file():
    src = _source_qtiles()
    bm, bn = QTILE
    assert (src["BM"], src["BN"], src["SLOTS"], src["RAW"], src["SC_ROWS"]) == \
        (bm, bn, QSLOTS, QRAW, SC_ROWS)
    smem = qgmm_smem_bytes()
    assert src["SMEM"] == smem == 222352 and smem <= SMEM_LIMIT
    # a fourth widened slot does not fit
    assert qgmm_smem_bytes(slots=4) > SMEM_LIMIT
    assert src["RAW_BYTES"] % 1024 == 0 and src["STAGE_BYTES"] % 1024 == 0   # tiles stay aligned
    # a consumer's accumulators: SUBS m64 row blocks of BN / 2 f32 registers, 128 in all
    assert src["SUBS"] * 2 * WG_ROWS == bm and src["SUBS"] * bn // 2 == 128
    assert bm <= 256 and bn % 64 == 0          # one TMA box of x's rows; whole swizzle blocks
    # three warpgroups at the launch's 168 registers a thread: the widening
    # warps keep theirs (no setmaxnreg in the quantized kernel)
    body = _source().split("void __launch_bounds__(kWgBlockThreads, 1) wg_qgmm_kernel(", 1)[1]
    body = body.split("\n}\n", 1)[0]
    assert "regs_dealloc" not in body and "regs_alloc" not in body
    assert _constant("kWidenWarps") == 3 and _constant("kWidenBatch") >= 1
    # the bf16 kernels' split: 168 a thread at launch, 24 / 240 after
    assert 128 * _constant("kProducerRegs") + 256 * _constant("kConsumerRegs") <= 384 * 168


def test_the_tall_tile_widens_half_the_weights_a_product():
    """A widened [64][BN] step feeds BM rows: widened elements per product
    1 / (2 BM), half wg_gmm's 128 x 256 tile's."""
    bm, bn = QTILE
    wide = (TILE["BM"], TILE["BN"])
    per = lambda m, n: (64 * n) / (2 * m * n * 64)
    assert per(bm, bn) == per(*wide) / 2 and bm * bn == wide[0] * wide[1]


def _fp8_values() -> np.ndarray:
    """fp8_to_float of every byte (NaN at 0x7F and 0xFF)."""
    return torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float().numpy()


def widen_values(raw: np.ndarray, scales: np.ndarray, fmt, rounding=True) -> np.ndarray:
    """The kernel's widening of raw bytes (uint8, any shape) with their
    scales (f32, broadcast): int8 b in its own bit path, the f32 of bits
    0x4B000000 | (b ^ 0x80) minus 2^23 + 128, times s; e4m3 through the
    e4m3 -> f16 -> f32 conversion (fp8_to_float's), times s. Rounded to bf16
    (as f32) unless ``rounding`` is off."""
    b = raw.astype(np.uint32)
    s = np.broadcast_to(scales.astype(np.float32), raw.shape)
    if fmt == 8:
        biased = (np.uint32(0x4B000000) | (b ^ np.uint32(0x80))).view(np.float32)
        v = (biased - np.float32(8388736.0)) * s
    else:
        with np.errstate(invalid="ignore"):
            v = _fp8_values()[raw] * s
    v = v.astype(np.float32)
    return torch.from_numpy(v).bfloat16().float().numpy() if rounding else v


@pytest.mark.parametrize("fmt", [8, "fp8"])
def test_widening_equals_the_dequantize_for_every_byte(fmt):
    """Every byte (e4m3's NaN bytes 0x7F / 0xFF, which the quantizer never
    writes, aside), at scales across the range (subnormal products and
    overflow), widens to bf16(q * s) with the product in f32:
    quant_gemv.cuh's deq<true> of q_value's q; for int8 the exact
    2^23 + b path equals the signed byte's value."""
    byte = np.arange(256, dtype=np.uint8)
    q = byte.view(np.int8).astype(np.float32) if fmt == 8 else _fp8_values()
    keep = ~np.isnan(q)
    scales = np.array([1.0, 3.1e-3, 1.7 / 448, 2.0 ** -130, 1e-40, 255.75, 256.0, 300.5, 1e30],
                      np.float32)
    for s in scales:
        with np.errstate(over="ignore"):
            prod = (q[keep] * s).astype(np.float32)
        want = torch.from_numpy(prod).bfloat16()
        got = torch.from_numpy(widen_values(byte[keep], np.float32(s), fmt)).bfloat16()
        assert torch.equal(got.view(torch.int16), want.view(torch.int16)), (fmt, s)
    if fmt == 8:   # the bit path's q is the signed byte, exactly
        biased = np.uint32(0x4B000000) | (byte.astype(np.uint32) ^ np.uint32(0x80))
        assert ((biased.view(np.float32) - np.float32(8388736.0)) == q).all()
    else:
        assert np.isnan(_fp8_values()[[0x7F, 0xFF]]).all() and _fp8_values()[0x7E] == 448.0


def widening_writes(gs: int, step: int, bn: int):
    """Where the widening warps write one step's [64][bn] B tile: for each
    (warp, lane, row) the byte offset in the slot's B tile, the K row it
    widens, its first column and the scale row (0 or 1 of the step's two)
    it multiplies by. A row is bn / 8 lanes of 8 columns (a 16-byte chunk
    of a 64-column block), a warp's instruction 256 / bn rows: warp w takes
    rows w * (256 / bn) + lane // (bn / 8), then every 3 * (256 / bn)-th;
    rows below ``split`` take the first scale row."""
    bk = TILE["BK"]
    k0 = step * bk
    split = min((k0 // gs + 1) * gs - k0, bk)
    per_row, rows = bn // 8, 256 // bn
    out = []
    for w in range(3):
        for lane in range(32):
            col = (lane % per_row) * 8
            for row in range(w * rows + lane // per_row, bk, 3 * rows):
                chunk = (col % 64) // 8
                at = (col // 64) * bk * 128 + row * 128 + ((chunk ^ (row & 7)) << 4)
                out.append((at, row, col, 0 if row < split else 1))
    return out


@pytest.mark.parametrize("gs", [32, 64, 96, 128, 256])
def test_widening_threads_write_each_element_once_with_its_scale_row(gs):
    bn = QTILE[1]
    bk = TILE["BK"]
    for step in range(6):
        writes = widening_writes(gs, step, bn)
        offsets = sorted(at for at, *_ in writes)
        # every 16-byte chunk of the tile, once: the 128-byte swizzle's places
        assert offsets == list(range(0, bk * bn * 2, 16))
        for at, row, col, part in writes:
            k = step * bk + row
            first = step * bk // gs
            assert k // gs == first + part            # the K row's own scale row
            # the swizzled place of (row, col) in its block: TMA's 128-byte swizzle
            blk = col // 64
            assert at == blk * bk * 128 + row * 128 + ((((col % 64) // 8) ^ (row % 8)) * 16)
        # a step spans at most two scale rows, since gs >= 32
        assert len({part for *_, part in writes}) <= 2


def qgmm_mirror(x, q, scales, gs, fmt, sizes, rounding=True, first_row_only=False):
    """The quantized kernel's arithmetic: per gmm block of its tile, 64-row
    steps of the raw weight tile (zeros past K and F, as TMA
    fills them) widened with the step's scale rows (its first below
    ``split``, else its second; zeros past K / gs), rounded to bf16, and the
    products added in 16-row k-steps in order; only the tile's own rows
    stored."""
    N, K = x.shape
    E, _, F = q.shape
    bm, bn = QTILE
    bk = TILE["BK"]
    out = np.full((N, F), np.nan, np.float32)
    for _, c, (row0, rows, g) in gmm_blocks(sizes, N, F, bm, bn):
        if g == -2:
            continue
        c0, c1 = c * bn, min(F, (c + 1) * bn)
        if g == -1:
            out[row0:row0 + rows, c0:c1] = 0
            continue
        A = _box(x, row0, bm)
        acc = np.zeros((bm, c1 - c0), np.float32)
        for k0 in range(0, K, bk):
            raw = np.zeros((bk, c1 - c0), np.uint8)
            part = q[g, k0:k0 + bk, c0:c1]
            raw[:len(part)] = part
            first = k0 // gs
            sc = np.zeros((2, c1 - c0), np.float32)
            for i in range(2):
                if first + i < K // gs:
                    sc[i] = scales[g, first + i, c0:c1]
            split = bk if first_row_only else min((first + 1) * gs - k0, bk)
            rows_sc = np.where((np.arange(bk) < split)[:, None], sc[0][None], sc[1][None])
            wide = widen_values(raw, rows_sc, fmt, rounding)
            a = np.zeros((bm, bk), np.float32)
            take = A[:, k0:k0 + bk]
            a[:, :take.shape[1]] = take
            for j in range(0, bk, 16):
                acc += a[:, j:j + 16] @ wide[j:j + 16]
        out[row0:row0 + rows, c0:c1] = acc[:rows]
    assert not np.isnan(out).any()
    return out


# (group size, K): K a multiple of the group size; 160 and 288 end on half a step
QUANT_GROUPS = [(32, 160), (64, 192), (96, 288), (256, 512)]
QUANT_CASES = [(fmt, gs, K, p) for fmt in (8, "fp8") for gs, K in QUANT_GROUPS
               for p in ("balanced", "one_expert", "empty_ends", "ragged")]


def _quantized_case(fmt, gs, K, pattern, N=300, F=264, groups=4):
    rng = np.random.default_rng(K + gs + (fmt == 8))
    sizes = group_sizes(pattern, N, rng, groups=groups)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = (rng.standard_normal((groups, K, F)) * K ** -0.5).astype(np.float32)
    qm = jqm.quantize_weight(jnp.asarray(w), gs, bits=fmt)
    assert qm.group_size == gs
    q = np.array(qm.q).view(np.uint8)
    return x, qm, q, np.array(qm.scales), sizes


@pytest.mark.parametrize("fmt,gs,K,pattern", QUANT_CASES)
def test_quantized_mirror_matches_jax_grouped_matmul(fmt, gs, K, pattern):
    """Without the bf16 rounding the mirror is JAX's f32 route (the stack
    dequantized to f32 before ragged_dot); with it, JAX's route over the
    stack JAX dequantizes and casts to bf16 (the activations' dtype on the
    card). Both within 1e-5."""
    x, qm, q, scales, sizes = _quantized_case(fmt, gs, K, pattern)
    js = jnp.asarray(sizes)
    want = np.asarray(jgg.grouped_matmul(jnp.asarray(x), qm, js))
    dense16 = qm.dequantize().astype(jnp.bfloat16).astype(jnp.float32)
    want16 = np.asarray(jgg.grouped_matmul(jnp.asarray(x), dense16, js))
    _close(qgmm_mirror(x, q, scales, gs, fmt, sizes, rounding=False), want, "f32 widening")
    _close(qgmm_mirror(x, q, scales, gs, fmt, sizes), want16, "bf16 widening")
    # and the port's plain version over the same storage, in f32
    tq = torch.from_numpy(q).view(torch.int8 if fmt == 8 else torch.float8_e4m3fn)
    tw = tqm.QuantizedMatrix(tq, torch.from_numpy(scales), gs, torch.float32, fmt)
    _close(gg.grouped_matmul_reference(torch.from_numpy(x), tw, torch.from_numpy(sizes)).numpy(),
           want, "plain")


@pytest.mark.parametrize("fmt", [8, "fp8"])
def test_a_mirror_reading_only_the_first_scale_row_misses_jax(fmt):
    """At group size 32 every 64-row step spans two scale groups: widening
    the step with its first scale row only is far from JAX."""
    x, qm, q, scales, sizes = _quantized_case(fmt, 32, 160, "ragged")
    want = np.asarray(jgg.grouped_matmul(jnp.asarray(x), qm, jnp.asarray(sizes)))
    bad = qgmm_mirror(x, q, scales, 32, fmt, sizes, rounding=False, first_row_only=True)
    assert np.abs(bad - want).max() > 1e-2


@pytest.mark.parametrize("fmt", [8, "fp8"])
@pytest.mark.parametrize("N", [17, 300])
def test_wrapper_hands_the_quantized_form_its_storage(recorded, monkeypatch, fmt, N):
    """A quantized stack goes to the kernel as its storage: q and the f32
    scales, the group size and the format code; past GEMV_MAX_N's 64 rows
    one split over K and no partials, up to them the GEMV's plan."""
    monkeypatch.setattr(gg, "_sms", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    K, F = 192, 272
    w = tqm.quantize_weight(torch.randn(E, K, F), 64, bits=fmt).to(None, torch.bfloat16)
    x = torch.zeros(N, K, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("ragged", N, np.random.default_rng(0)))
    out = gg._launch(x, w, sizes)
    args = recorded.pop("sxt_grouped_matmul_bf16")
    assert args[:5] == (x.data_ptr(), w.q.data_ptr(), w.scales.data_ptr(), sizes.data_ptr(),
                        out.data_ptr())
    assert args[6:12] == (N, K, F, E, 64, gg.FORMATS[fmt])
    if N > gg.GEMV_MAX_N[fmt]:
        assert args[5] is None and args[12:14] == (1, K)
    else:
        assert args[12:14] == gg.gemv_split(K, 64, F, E, N, 1, 132)
    assert not recorded
