"""B8 past the decode rows and B9 at multi-token rows and wide ranks,
redesigned for Hopper, on the CPU: what of their design can be held
without the card.

B8 (``ops/csrc/quant_matmul.cu``): past 8 rows every call runs the
quantized grouped GEMM's ``wgmma`` block (``ops/csrc/wgmma_qgemm.cuh``:
``qgemm_tile``) over the one matrix, int4 included, on a 128-row tile up to
128 rows, with the reduction split across blocks where the tiles are few.
- The block's shared memory against the header's ``WgQGemm`` /
  ``WgQGemmShort`` and an H100 block's 232,448 B; the wrapper's tile
  constants and tile rule against the source's.
- The split schedule (``wgmma_splits``) covers every 64-row step once, in
  whole steps, splits in order; the band raster covers every output tile
  once.
- A plain f32 mirror of the tiled arithmetic (64-row logical steps, int4's
  four 16-row pieces of packed rows with their nibble, at most two scale
  rows a step, bf16(q * s), 16-row k-steps, split partials added in split
  order) against JAX ``quant_matmul`` and ``_quant_matmul_pallas
  (interpret=True)`` at group sizes 32, 64 and 256 in every format within
  1e-5; a mirror with int4's halves swapped misses.

B9 (``ops/csrc/lora_gemm.cu``): one-token rows past rank 8 and every
multi-token call run a shrink kernel (mid = x @ A on the tensor cores, D
split into a thread block cluster whose blocks add their sums in split
order) and an expand kernel (mid as two bf16 terms against B).
- Both kernels' shared memory against the source's expressions; the
  cluster's sums fit the shrink's ring; the wrapper's constants against the
  source's.
- The D splits depend on T, D and R only, stay within one portable
  cluster, cover D once; the cluster's fold slices cover every element
  once; the expand's column ranges cover N once.
- A mirror of the split-mid second product (D splits added in order, mid
  as hi + lo bf16 terms against B's bf16 values) against
  ``lora_delta_oracle`` and ``lora_delta_pallas(interpret=True)`` within
  1e-5 of the output's largest value at ranks 8, 64, 128 and 136, and
  within the split's proven bound, 2^-16 of sum |mid| |B| per element; a
  mirror with mid rounded to one bf16 (the Punica form) misses by 100x.

Both: the wrappers' C arguments, and ``quant_mma_kernel`` and the
``*_wide_kernel`` forms gone with no path back to them.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jqm = importlib.import_module("shuffle_exchange_tpu.ops.quant_matmul")
jlg = importlib.import_module("shuffle_exchange_tpu.ops.lora_gemm")
tqm = importlib.import_module("shuffle_exchange_tpu_torch.ops.quant_matmul")
tlg = importlib.import_module("shuffle_exchange_tpu_torch.ops.lora_gemm")
CSRC = Path(tqm.__file__).parent / "csrc"
SMEM_LIMIT = 232448   # dynamic shared memory an H100 block can have
SMS = 132             # the H100's SMs
STEP = 64             # B8's reduction rows a step; B9's D rows a shrink step


def _text(name: str) -> str:
    return (CSRC / name).read_text()


def _constants(text: str) -> dict:
    """Every ``constexpr int NAME = <int expression>;`` of a source, evaluated
    in order."""
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text, re.M):
        env[name] = eval(" ".join(expr.split()).replace("/", "//"), {}, env)
    return env


def _function_expr(text: str, name: str) -> str:
    """The return expression of a one-line ``constexpr`` helper."""
    body = re.search(rf"constexpr \w+ {name}\([^)]*\) \{{(.*?)\}}", text, re.S).group(1)
    return " ".join(body.split()).removeprefix("return ").rstrip(";")


# ---------------------------------------------------------------------------
# B8: the shared block's shared memory and constants
# ---------------------------------------------------------------------------


def _qgemm_tiles(struct: str = "WgQGemm") -> dict:
    """A tile struct's constants (``WgQGemmShort``'s ``WgQGemm::`` terms
    from ``WgQGemm``'s)."""
    text = _text("wgmma_qgemm.cuh")
    env = _constants(text)
    base = {}
    if struct != "WgQGemm":
        base = {f"WgQGemm__{k}": v for k, v in _qgemm_tiles().items()}
    env.update(base)
    body = text.split(f"struct {struct} {{", 1)[1].split("};", 1)[0]
    for decl in re.findall(r"static constexpr int ([^;]+);", body):
        for name, expr in re.findall(r"(\w+) =\s*((?:[^,(]|\([^)]*\))+)", decl):
            expr = " ".join(expr.split()).replace("WgQGemm::", "WgQGemm__").replace("/", "//")
            env[name] = eval(expr, {}, env)
    return env


def test_b8_block_fits_shared_memory_and_matches_the_wrapper():
    src = _qgemm_tiles()
    bm, bn = tqm.WG_TILE
    assert (src["BM"], src["BN"], src["BK"]) == (bm, bn, tqm.WG_STEP) == (256, 128, STEP)
    # x's [256][64] and the bf16 [64][128] B tile, 3 deep; the one-byte
    # [64][128] tile and two f32 scale rows, 6 deep; two [64][64] staging
    # tiles (144-byte rows); the barriers; 1024 bytes of alignment slack
    smem = (1024 + 3 * (bm * 64 + 64 * bn) * 2 + 6 * (64 * bn + 2 * bn * 4) + 2 * 64 * 144
            + 8 * 2 * (3 + 6))
    assert src["SMEM"] == smem == 222352 <= SMEM_LIMIT == src["kSmemLimit"]
    # int4's pieces: 16 logical rows, inside one half of a group (gs % 32 == 0)
    assert src["PIECE"] == 16 and src["BK"] % src["PIECE"] == 0
    assert src["Q_BYTES"] == 64 * bn                   # int4's four pieces fill int8's raw tile
    assert tqm.GEMV_ROWS == 8                          # the GEMV keeps the decode rows
    # the short tile: 128 x 128, one m64 block a consumer, the same stages
    short = _qgemm_tiles("WgQGemmShort")
    assert (short["BM"], short["BN"], short["SUBS"]) == (tqm.WG_SHORT_ROWS, bn, 1) == (128, 128, 1)
    assert short["SMEM"] == smem - 3 * 128 * 64 * 2 <= SMEM_LIMIT
    assert short["STAGE_BYTES"] % 1024 == 0


@pytest.mark.parametrize("M", [9, 64, 128, 129, 256, 8192])
def test_b8_short_tile_spans_the_calls_of_few_rows(M):
    # the C entry point picks the tile by the rule the split schedule counts
    assert "if (M <= WgQGemmShort::BM) {" in _text("quant_matmul.cu")
    rows = tqm.wgmma_tile_rows(M)
    assert rows == (128 if M <= 128 else 256)
    assert -(-M // rows) == (1 if M <= 256 else -(-M // 256))   # one row tile to 256 rows


# ---------------------------------------------------------------------------
# B8: the split schedule and the raster
# ---------------------------------------------------------------------------

SPLIT_GRID = [(M, K, N) for M in (9, 37, 256, 1000, 8192) for K, N in
              ((4096, 14336), (4096, 4096), (4096, 1024), (14336, 4096), (1024, 1040), (160, 272))]


@pytest.mark.parametrize("M,K,N", SPLIT_GRID)
def test_b8_splits_cover_every_step_once_in_order(M, K, N):
    splits, chunk = tqm.wgmma_splits(M, K, N, SMS)
    steps = -(-K // STEP)
    assert chunk % STEP == 0 and (splits - 1) * chunk < K <= splits * chunk
    per = chunk // STEP
    owner = [s for s in range(splits) for _ in range(per)][:steps]
    assert owner == sorted(owner) and set(owner) == set(range(splits))   # each split nonempty
    tiles = -(-M // tqm.wgmma_tile_rows(M)) * -(-N // tqm.WG_TILE[1])
    if 2 * tiles > SMS:
        assert splits == 1
    elif splits > 1:
        assert tiles * splits <= SMS and per >= tqm.WG_MIN_STEPS   # one wave, whole steps


def _raster(b, slots, col_tiles, band):
    band_i, r = divmod(b, band * col_tiles)
    width = min(band, slots - band_i * band)
    return band_i * band + r % width, r // width


@pytest.mark.parametrize("row_tiles,col_tiles", [(1, 112), (1, 8), (4, 9), (32, 112), (33, 32)])
def test_b8_raster_covers_every_tile_once(row_tiles, col_tiles):
    band = _constants(_text("wgmma_qgemm.cuh"))["kBand"]
    seen = [_raster(b, row_tiles, col_tiles, band) for b in range(row_tiles * col_tiles)]
    assert sorted(seen) == [(y, c) for y in range(row_tiles) for c in range(col_tiles)]


# ---------------------------------------------------------------------------
# B8: a mirror of the tiled arithmetic
# ---------------------------------------------------------------------------


def _fp8_values() -> np.ndarray:
    return torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float().numpy()


def _bf16(a) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def int4_piece_row(k, gs):
    """The kernel's int4_piece_row: the first packed row of the 16-row
    piece at logical row k, and whether it takes the high nibble."""
    g, o, half = k // gs, k % gs, gs // 2
    high = o >= half
    return g * half + (o - half if high else o), high


def b8_mirror(x, q, scales, gs, fmt, K, splits=1, chunk=None, rounding=True, swap=False):
    """The wgmma form's arithmetic on storage bytes ``q`` (uint8: int8 /
    e4m3 [K, N], int4 [K/2, N]): per split, 64-row logical steps whose raw
    tile is int8's rows or int4's four 16-row pieces of packed rows (each
    its nibble: ``swap`` takes the other), widened with the step's scale
    rows (the first below ``split``, the second from it; zeros past the
    tensors, as TMA fills them), rounded to bf16, products added in 16-row
    k-steps; the splits' f32 partials added in split order."""
    M, N = x.shape[0], scales.shape[1]
    chunk = chunk or -(-K // STEP) * STEP
    out = np.zeros((M, N), np.float32)
    fp8 = _fp8_values()
    for s in range(splits):
        acc = np.zeros((M, N), np.float32)
        for k0 in range(s * chunk, min(K, (s + 1) * chunk), STEP):
            vals = np.zeros((STEP, N), np.float32)
            if fmt == 4:
                for p in range(STEP // 16):
                    prow, high = int4_piece_row(k0 + 16 * p, gs)
                    rows = q[prow:prow + 16].astype(np.int32)
                    nib = (rows >> 4 if high != swap else rows) & 0xF
                    vals[16 * p:16 * p + len(rows)] = (nib ^ 8) - 8
            else:
                rows = q[k0:k0 + STEP]
                vals[:len(rows)] = rows.view(np.int8) if fmt == 8 else fp8[rows]
            first = k0 // gs
            sc = np.zeros((2, N), np.float32)
            for i in range(2):
                if first + i < K // gs:
                    sc[i] = scales[first + i]
            split = min((first + 1) * gs - k0, STEP)
            w = (vals * np.where((np.arange(STEP) < split)[:, None], sc[0], sc[1])).astype(
                np.float32)
            w = _bf16(w) if rounding else w
            a = np.zeros((M, STEP), np.float32)
            take = x[:, k0:k0 + STEP]
            a[:, :take.shape[1]] = take
            for j in range(0, STEP, 16):
                acc += a[:, j:j + 16] @ w[j:j + 16]
        out += acc
    return out


B8_CASES = [(fmt, gs) for fmt in (8, 4, "fp8") for gs in (32, 64, 256)]


def _b8_case(fmt, gs, M=40, K=512, N=144):
    rng = np.random.default_rng(gs + (fmt == 4) + 2 * (fmt == 8))
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    qm = jqm.quantize_weight(jnp.asarray(w), gs, bits=fmt)
    assert qm.group_size == gs
    return x, qm, np.array(qm.q).view(np.uint8), np.array(qm.scales)


def _close(got, want, what, tol=1e-5):
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max abs err {err}"


@pytest.mark.parametrize("fmt,gs", B8_CASES)
def test_b8_mirror_matches_jax_and_the_pallas_kernel(fmt, gs):
    """Without the bf16 rounding the mirror is the TPU kernel's arithmetic
    (x against q * s in f32) and JAX's f32 route; with it, JAX's route over
    the weight dequantized and cast to bf16 (the default on the card).
    The split schedule of 40 rows (16 splits at K 512: two steps each, a
    split of the grid's 2 tiles) gives the same sums within 1e-5."""
    x, qm, q, scales = _b8_case(fmt, gs)
    K = x.shape[1]
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qm))
    pallas = np.asarray(jqm._quant_matmul_pallas(jnp.asarray(x), qm, interpret=True))
    f32 = b8_mirror(x, q, scales, gs, fmt, K, rounding=False)
    _close(f32, want, "f32 widening vs quant_matmul")
    _close(f32, pallas, "f32 widening vs _quant_matmul_pallas")
    dense16 = np.asarray(qm.dequantize().astype(jnp.bfloat16).astype(jnp.float32))
    _close(b8_mirror(x, q, scales, gs, fmt, K), x @ dense16, "bf16 widening")
    splits, chunk = 4, 128
    _close(b8_mirror(x, q, scales, gs, fmt, K, splits, chunk, rounding=False), want,
           "split reduction")


@pytest.mark.parametrize("gs", [32, 64, 256])
def test_b8_int4_mirror_with_halves_swapped_misses(gs):
    x, qm, q, scales = _b8_case(4, gs)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qm))
    bad = b8_mirror(x, q, scales, gs, 4, x.shape[1], rounding=False, swap=True)
    assert np.abs(bad - want).max() > 1e-2


def test_b8_int4_pieces_pair_packed_rows_as_the_packing_does():
    """Every logical row k of an int4 weight is packed row int4_piece_row's
    row + (k % 16), in the nibble it names: the inverse of ``_pack_int4``."""
    for gs in (32, 64, 96, 256, 1024):
        K = 4 * gs
        logical = torch.arange(K * 3, dtype=torch.int32).reshape(K, 3) % 15 - 7
        packed = tqm._pack_int4(logical, gs).numpy().astype(np.int32)
        for k in range(0, K, 16):
            prow, high = int4_piece_row(k, gs)
            nib = (packed[prow:prow + 16] >> 4 if high else packed[prow:prow + 16]) & 0xF
            assert np.array_equal((nib ^ 8) - 8, logical[k:k + 16].numpy()), (gs, k)


# ---------------------------------------------------------------------------
# B9: shared memory, constants, schedules
# ---------------------------------------------------------------------------


def _lora_env() -> dict:
    return _constants(_text("lora_gemm.cu"))


def _round16(r):
    return (r + 15) // 16 * 16


def test_b9_blocks_fit_shared_memory_and_match_the_wrapper():
    text = _text("lora_gemm.cu")
    env = _lora_env()
    assert (env["kTile"], env["kStep"], env["kLd"]) == (64, 64, 72)
    assert env["kExpandCols"] % 64 == 0
    assert (tlg.TILE, tlg.MAX_SPLITS, tlg.ROW_RANK) == (
        env["kTile"], env["kMaxSplits"], env["kRowRank"])
    assert env["kMaxSplits"] <= 8                       # a portable thread block cluster
    shrink = _function_expr(text, "shrink_smem")
    expand = _function_expr(text, "expand_smem")
    for nt in (2, 4, 8, 16):
        smem = eval(shrink.replace("/", "//"), {}, dict(env, nt=nt))
        # a ring of (x [64][72], A [64][8 nt + 8]) bf16 stages
        assert smem == env["kShrinkStages"] * (64 * 72 + 64 * (8 * nt + 8)) * 2 <= SMEM_LIMIT
        assert 64 * 8 * nt * 4 <= smem                  # the cluster's f32 sums reuse the ring
    expand = expand.replace("(round16(R) < kStep ? round16(R) : kStep)", "min(round16(R), kStep)")
    expand = re.sub(r"\(mid_resident\(R\) \? (.*?)\s*: (.*?)\) \* 2 \+", r"((\1) if "
                    r"mid_resident(R) else (\2)) * 2 +", " ".join(expand.split()))
    resident = _function_expr(text, "mid_resident")
    assert resident == "round16(R) <= kResidentRank" and env["kResidentRank"] == 512
    ld_b = env["kExpandCols"] + 8
    for R in (8, 12, 64, 65, 128, 136, 256, 512, 513, 1024, 4000):
        smem = eval(expand.replace("/", "//"), {}, dict(
            env, R=R, round16=_round16, mid_resident=lambda r: _round16(r) <= 512))
        if R <= 512:
            # the B ring (the ranks a stage reads, to 64), mid's two terms for
            # 64 tokens, four [16][kExpandCols + 8] staging tiles
            assert smem == (env["kStages"] * min(_round16(R), 64) * ld_b
                            + 2 * 64 * (_round16(R) + 8) + 4 * 16 * ld_b) * 2
        else:
            # each ring stage: B's [64][ld_b] tile and its ranks of mid's two
            # terms [64][72] each; the staging tiles
            assert smem == (env["kStages"] * (64 * ld_b + 2 * 64 * 72) + 4 * 16 * ld_b) * 2
        assert smem <= SMEM_LIMIT
    # the wrapper's rank chunk is the shrink's n8 tiles x 8
    tiles = _function_expr(text, "shrink_tiles")
    assert tiles == "R > 64 ? 16 : R > 32 ? 8 : R > 16 ? 4 : 2"
    for R in range(1, 520):
        assert tlg.rank_chunk(R) == 8 * (16 if R > 64 else 8 if R > 32 else 4 if R > 16 else 2)


B9_SHAPES = [(T, D, R) for T in (1, 3, 64, 77, 256, 1024, 2048) for D in (1000, 4096)
             for R in (8, 12, 64, 65, 128, 136, 256)]


@pytest.mark.parametrize("T,D,R", B9_SHAPES[::3])
def test_b9_splits_cover_d_once_within_a_cluster(T, D, R):
    splits, chunk = tlg.shrink_splits(T, D, R)
    assert chunk % STEP == 0 and (splits - 1) * chunk < D <= splits * chunk
    assert 1 <= splits <= tlg.MAX_SPLITS and (splits == 1 or chunk >= 4 * STEP)
    # the cluster's fold: each block adds a slice of the (token, 4 ranks)
    # cells over the splits; the slices cover every cell once
    for tt in (1, 17, 64):
        for cw in {tlg.rank_chunk(R), _round16(R) % tlg.rank_chunk(R) or tlg.rank_chunk(R)}:
            cells = tt * min(cw, _round16(R)) // 4
            per = -(-cells // splits)
            slices = [range(q * per, min(cells, (q + 1) * per)) for q in range(splits)]
            assert sorted(i for s in slices for i in s) == list(range(cells))


def test_b9_splits_depend_on_the_row_shape_only():
    """A row's D splits (and so its sums) do not move with B or N: the
    schedule's arguments are T, D and R."""
    import inspect

    assert list(inspect.signature(tlg.shrink_splits).parameters) == ["T", "D", "R"]
    assert "expand_col_splits" in tlg.__all__


@pytest.mark.parametrize("B,T,N", [(1, 1, 4096), (8, 1, 1001), (2, 256, 4096), (8, 1024, 4096),
                                   (3, 77, 40)])
def test_b9_expand_columns_cover_n_once(B, T, N):
    col_splits = tlg.expand_col_splits(B, T, N)
    tiles_n = -(-N // 64)
    split_cols = -(-tiles_n // col_splits) * 64
    ranges = [range(z * split_cols, min(N, (z + 1) * split_cols))
              for z in range(-(-N // split_cols))]
    assert sorted(n for r in ranges for n in r) == list(range(N))
    assert all(len(r) for r in ranges)


# ---------------------------------------------------------------------------
# B9: a mirror of the split-mid products
# ---------------------------------------------------------------------------


def _lora_case(R, B=5, T=40, D=256, N=128, S=4, seed=0):
    rng = np.random.default_rng(seed + R)
    x = _bf16(rng.standard_normal((B, T, D)))
    a = _bf16(rng.standard_normal((S, D, R)) * 0.1)
    b = _bf16(rng.standard_normal((S, R, N)) * 0.1)
    a[0], b[0] = 0.0, 0.0
    return x, a, b, np.array([0, 1, 2, 1, 3][:B], np.int32)


def b9_mirror(x, a, b, slots, terms=2):
    """The shrink's sums over each D split in f32, added in split order
    (``shrink_splits``), mid as ``terms`` bf16 terms (two: hi = bf16(mid),
    lo = bf16(mid - hi)), each against B's bf16 values, summed in f32.
    Also returns sum_r |mid| |B|, the split's error scale."""
    B, T, D = x.shape
    R = a.shape[2]
    splits, chunk = tlg.shrink_splits(T, D, R)
    mid = np.zeros((B, T, R), np.float32)
    for s in range(splits):
        part = np.einsum("btd,bdr->btr", x[:, :, s * chunk:(s + 1) * chunk].astype(np.float64),
                         a[slots, s * chunk:(s + 1) * chunk].astype(np.float64))
        mid += part.astype(np.float32)
    hi = _bf16(mid)
    use = hi if terms == 1 else hi + _bf16(mid - hi).astype(np.float64)
    bs = b[slots].astype(np.float64)
    out = np.einsum("btr,brn->btn", use, bs).astype(np.float32)
    scale = np.einsum("btr,brn->btn", np.abs(mid.astype(np.float64)), np.abs(bs))
    return out, scale


@pytest.mark.parametrize("R", [8, 64, 128, 136])
def test_b9_split_mid_mirror_matches_the_oracle_and_the_pallas_kernel(R):
    x, a, b, slots = _lora_case(R)
    got, scale = b9_mirror(x, a, b, slots)
    for want in (np.asarray(jlg.lora_delta_oracle(x, a, b, slots)),
                 np.asarray(jlg.lora_delta_pallas(x, a, b, slots, interpret=True))):
        err = np.abs(got - want)
        assert err.max() <= 1e-5 * np.abs(want).max()
        # the two terms drop at most 2^-16 of |mid| (round to nearest twice);
        # 1e-6 of the output's scale covers the f32 sums' order
        assert (err <= 2.0 ** -16 * scale + 1e-6 * np.abs(want).max()).all()
    assert not got[0].any()                             # the null row: exact zeros


@pytest.mark.parametrize("R", [8, 64, 128, 136])
def test_b9_mirror_with_mid_in_one_bf16_misses(R):
    x, a, b, slots = _lora_case(R)
    want = np.asarray(jlg.lora_delta_oracle(x, a, b, slots))
    bad, _ = b9_mirror(x, a, b, slots, terms=1)
    good, _ = b9_mirror(x, a, b, slots)
    assert np.abs(bad - want).max() > 100 * max(np.abs(good - want).max(), 1e-5 * np.abs(
        want).max() / 10)


# ---------------------------------------------------------------------------
# The wrappers' C arguments; the replaced kernels gone
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
    for mod in (tqm, tlg):
        monkeypatch.setattr(mod, "_lib", lambda: _Lib(calls))
    monkeypatch.setattr(tqm, "_sms", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7}))
    return calls


@pytest.mark.parametrize("fmt", [8, 4, "fp8"])
@pytest.mark.parametrize("M,K,N", [(8, 512, 144), (9, 512, 144), (256, 4096, 1024),
                                   (8192, 256, 144)])
def test_b8_wrapper_hands_the_c_entry_point_its_form(recorded, fmt, M, K, N):
    qm = tqm.quantize_weight(torch.randn(K, N), 256 if K % 256 == 0 else 64, bits=fmt).to(
        None, torch.bfloat16)
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    out = tqm._launch(x, qm)
    args = recorded.pop("sxt_quant_matmul_bf16")
    assert not recorded and out.shape == (M, N)
    assert args[:4] == (x.data_ptr(), qm.q.data_ptr(), qm.scales.data_ptr(), out.data_ptr())
    assert len(args) == 13 and args[5:10] == (M, K, N, qm.group_size, tqm.FORMATS[fmt])
    assert args[12] == 7
    if M <= tqm.GEMV_ROWS:
        splits, chunk = tqm.quant_splits(K, qm.group_size, (N,), SMS)
    else:
        splits, chunk = tqm.wgmma_splits(M, K, N, SMS)
        assert chunk % STEP == 0
    assert args[10:12] == (splits, chunk)
    assert (args[4] is None) == (M > tqm.GEMV_ROWS and splits == 1)   # f32 partials otherwise


def test_b8_wrapper_copies_an_unaligned_x(recorded):
    qm = tqm.quantize_weight(torch.randn(256, 144), 64).to(None, torch.bfloat16)
    x = torch.zeros(20 * 256 + 1, dtype=torch.bfloat16)[1:].view(20, 256)   # 2 bytes off
    assert x.is_contiguous() and x.data_ptr() % 16
    tqm._launch(x, qm)
    assert recorded.pop("sxt_quant_matmul_bf16")[0] % 16 == 0   # TMA's 16-byte base


def test_the_replaced_kernels_are_gone():
    """quant_mma_kernel (B8's mma.sync form) and lora_row_wide_kernel /
    lora_tile_wide_kernel / lora_tile_kernel (B9's CUDA-core forms past
    one-token rows) exist in no source; B8's tensor-core rows route only to
    wg_qmatmul_kernel, B9's other calls only to the shrink / expand pair."""
    sources = {p.name: p.read_text() for p in CSRC.iterdir()}
    for gone in ("quant_mma_kernel", "lora_row_wide_kernel", "lora_tile_wide_kernel",
                 "lora_tile_kernel", "launch_mma<", "lanes_per_item"):
        assert not any(gone in text for text in sources.values()), gone
    qmm = sources["quant_matmul.cu"]
    assert qmm.count("<<<") == 3          # the wgmma kernel and the split sum, the GEMV's sum
    for fmt in ("kQInt8", "kQInt4", "kQFp8"):
        assert f"launch_wg<{fmt}, WgQGemm>" in qmm and f"launch_wg<{fmt}, WgQGemmShort>" in qmm
    lora = sources["lora_gemm.cu"]
    kernels = set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)", lora))
    assert kernels == {"lora_row_kernel", "lora_shrink_kernel", "lora_expand_kernel"}
    assert "cudaLaunchAttributeClusterDimension" in lora
    py = Path(tqm.__file__).read_text() + Path(tlg.__file__).read_text()
    assert "mma_splits" not in py.replace("wgmma_splits", "") and "environ" not in py
