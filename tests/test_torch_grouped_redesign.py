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
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jgg = importlib.import_module("shuffle_exchange_tpu.ops.grouped_gemm")
gg = importlib.import_module("shuffle_exchange_tpu_torch.ops.grouped_gemm")
CU = (gg.__file__.rsplit("/", 1)[0]) + "/csrc/grouped_gemm.cu"
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
    return open(CU).read()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", _source()).group(1))


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


def gmm_blocks(sizes, N, C):
    """The gmm launch: (row slot, column tile, (row0, rows, group)) of
    every block in issue order; C is the output width (F; dx: K)."""
    slots, col_tiles = -(-N // TILE["BM"]) + len(sizes), -(-C // TILE["BN"])
    out = []
    for b in range(slots * col_tiles):
        y, c = raster(b, slots, col_tiles)
        out.append((y, c, find_tile(sizes, N, TILE["BM"], y)))
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


@pytest.mark.parametrize("N", [17, 300])
def test_wrappers_hand_the_c_entry_points_operands_shapes_and_form(recorded, N):
    K, F = 136, 264
    x = torch.zeros(N, K, dtype=torch.bfloat16)
    w = torch.zeros(E, K, F, dtype=torch.bfloat16)
    dout = torch.zeros(N, F, dtype=torch.bfloat16)
    sizes = torch.tensor(group_sizes("ragged", N, np.random.default_rng(0)))
    out = gg._launch(x, w, sizes)
    args = recorded.pop("sxt_grouped_matmul_bf16")
    # x, w, no scales, sizes, out, no partials (N > 16: the wgmma kernel), the
    # shapes, bf16 (code 3), one split over K
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
    for gone in ("grouped_dx_kernel", "grouped_dw_kernel", "DxStage", "DwStage"):
        assert gone not in src
    # the mma.sync tensor-core form is built for the quantized formats only
    assert 'static_assert(FMT == kQInt8 || FMT == kQFp8, "bf16 weights take wg_gmm_kernel")' in src
    assert "launch_gmm<false>" in src and "launch_gmm<true>" in src
    py = open(gg.__file__).read()
    assert "environ" not in py and "getenv" not in py
