"""Which instance or variant of K4 ``flash_attention``, K3 ``rmsnorm`` /
K3b ``rmsnorm_bwd`` and K6 ``decode_attention`` a call takes, decided on
the host before the launch (so checked here on the CPU), and the constants
the wrappers share with the CUDA sources, read from the ``.cu`` files: a
mismatch would have the card refuse every launch or cover a row (or a
cache) only in part."""
import re

import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.rmsnorm import kernel as rn_kernel


def _source(family, name: str) -> str:
    return (family.csrc / family.sources[name]).read_text()


def _const(text: str, name: str) -> int:
    got = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(got) == 1, (name, got)
    return int(got[0])


def test_flash_attention_constants_match_the_cuda_source():
    """K4's instance codes, the widths each takes and the tensor-core
    instances' tiles, as ``flash_attention.cu`` defines them."""
    text = _source(fa_kernel.FAMILY, "flash_attention")
    codes = re.search(r"enum Instance \{([^}]*)\}", text).group(1)
    names = [part.split("=")[0].strip().lower() for part in codes.split(",")]
    values = [int(part.split("=")[1]) for part in codes.split(",")]
    assert names == list(fa_kernel.INSTANCES)
    assert values == list(range(len(fa_kernel.INSTANCES)))
    assert _const(text, "TC_D_SMALL") == fa_kernel.INSTANCE_D["tc64"] == 64
    assert _const(text, "TC_D_MAX") == fa_kernel.INSTANCE_D["tc128"] == 128
    assert _const(text, "TC_BQ") == fa_kernel.TC_BQ
    assert _const(text, "TC_BKV") == fa_kernel.TC_BKV
    assert fa_kernel.INSTANCE_D["simt256"] == fa_kernel.D_MAX == 256


@pytest.mark.parametrize("d,want", [
    (1, "tc64"), (16, "tc64"), (63, "tc64"), (64, "tc64"),
    (65, "tc128"), (80, "tc128"), (100, "tc128"), (112, "tc128"),
    (127, "tc128"), (128, "tc128"),
    (129, "simt256"), (200, "simt256"), (255, "simt256"), (256, "simt256")])
def test_flash_attention_instance_choice(d, want):
    """K4's instance by D alone: the tensor cores up to D = 128 (musicgen's
    64, zamba2's 112, moonshot's and pixtral's 128), the fp32 CUDA-core
    instance above (gemma3-1b's 256)."""
    assert fa_kernel.instance(d) == want


@pytest.mark.parametrize("d", [0, -1, 257, 512])
def test_flash_attention_instance_refuses_other_widths(d):
    with pytest.raises(ValueError):
        fa_kernel.instance(d)


def test_rmsnorm_constants_match_the_cuda_source():
    """K3's variant codes, D_MAX and the "block" variant's limits, as
    ``rmsnorm.cu`` defines them."""
    text = _source(rn_kernel.FAMILY, "rmsnorm")
    codes = dict((name.lower(), int(v)) for name, v in re.findall(
        r"VARIANT_(\w+) = (\d+)", text))
    assert codes == {name: i for i, name in enumerate(rn_kernel.VARIANTS)}
    assert _const(text, "D_MAX") == rn_kernel.D_MAX
    assert _const(text, "BLOCK_NV") == rn_kernel.BLOCK_NV
    assert _const(text, "BLOCK_WARPS") == rn_kernel.BLOCK_WARPS


def _rows(rows: int, d: int, dtype) -> torch.Tensor:
    return torch.zeros(rows, d, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 7, 8, 9, 32, 33, 300, 2111, 8192,
                                  10240])
@pytest.mark.parametrize("d", [256, 1152, 2048, 2056, 3584, 4096, 5120,
                               7168, 8192])
def test_rmsnorm_block_variant_covers_the_row(dtype, rows, d):
    """Where K3 takes "block", its nv gives a block of W = ceil(vectors /
    (32 nv)) <= 32 warps that covers the row with at most BLOCK_NV vectors
    a lane: the fewest warps that allows when the rows fill the card, and
    at decode's 8 rows as many as d allows."""
    x = _rows(rows, d, dtype)
    kind, nv = rn_kernel.variant(x, torch.zeros(d, dtype=dtype))
    if d <= rn_kernel.D_MAX and rows >= rn_kernel.WARP_ROWS:
        assert kind == "warp"
        return
    assert kind == "block"
    nvec = d // (16 // x.element_size())
    warps = -(-nvec // (32 * nv))
    assert 1 <= nv <= rn_kernel.BLOCK_NV and warps <= rn_kernel.BLOCK_WARPS
    assert 32 * warps * nv >= nvec
    fewest = -(-nvec // (32 * rn_kernel.BLOCK_NV))
    if rows >= rn_kernel.FILL_WARPS:        # enough rows: fewest warps
        assert warps == fewest
    if rows == 8:                           # decode: as many as d allows
        assert nv == -(-nvec // (32 * min(rn_kernel.BLOCK_WARPS,
                                          -(-nvec // 32))))


def test_rmsnorm_bwd_constants_match_the_cuda_source():
    """K3b's variant codes (K3's), D_MAX and its "block" variant's limits,
    as ``rmsnorm_bwd.cu`` defines them."""
    text = _source(rn_kernel.FAMILY, "rmsnorm_bwd")
    codes = dict((name.lower(), int(v)) for name, v in re.findall(
        r"VARIANT_(\w+) = (\d+)", text))
    assert codes == {name: i for i, name in enumerate(rn_kernel.VARIANTS)}
    assert _const(text, "D_MAX") == rn_kernel.D_MAX
    assert _const(text, "BLOCK_NV") == rn_kernel.BLOCK_NV
    assert _const(text, "BLOCK_WARPS") == rn_kernel.BWD_BLOCK_WARPS


def _k3b_rule(x, scale, g) -> tuple:
    """K3b's variant rule, written out: "scalar" unless x, g and scale are
    16-byte aligned, then "warp" up to D_MAX and past it "block" over at
    most BWD_BLOCK_WARPS warps with the fewest vectors a lane that allows,
    "loop" where that is more than BLOCK_NV, whatever the row count."""
    d = x.shape[1]
    size = x.element_size()
    epv = 16 // size
    aligned = (d % epv == 0 and scale.data_ptr() % 16 == 0
               and all(t.stride(0) * size % 16 == 0 and t.data_ptr() % 16 == 0
                       for t in (x, g)))
    if not aligned:
        return "scalar", 0
    nvec = d // epv
    if d <= rn_kernel.D_MAX:
        return "warp", -(-nvec // 32)
    for nv in range(1, rn_kernel.BLOCK_NV + 1):
        if 32 * nv * rn_kernel.BWD_BLOCK_WARPS >= nvec:
            return "block", nv
    return "loop", 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 1152), (8, 2048),
                                    (8, 4096), (8, 7168), (9, 2056),
                                    (300, 256), (4096, 1152),
                                    (4096, 3584), (16384, 256)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_bwd_choice_follows_its_rule(dtype, rows, d, offset):
    """K3b (``variant`` given g) keeps its own rule, not K3's: "warp" up to
    D_MAX at any row count, "block" past it (the SSM widths 3584 / 4096 /
    7168 among them), "scalar" one element off a 16-byte boundary; a
    "block" choice covers the row with at most BLOCK_NV vectors a lane over
    at most BWD_BLOCK_WARPS warps."""
    buf = torch.zeros(rows * d + offset, dtype=dtype)
    x = buf[offset:].view(rows, d)
    g = torch.zeros(rows, d, dtype=dtype)
    s = torch.zeros(d, dtype=dtype)
    kind, nv = rn_kernel.variant(x, s, g)
    assert (kind, nv) == _k3b_rule(x, s, g)
    if kind == "block":
        nvec = d // (16 // x.element_size())
        warps = -(-nvec // (32 * nv))
        assert 1 <= nv <= rn_kernel.BLOCK_NV
        assert warps <= rn_kernel.BWD_BLOCK_WARPS
        assert 32 * warps * nv >= nvec > 32 * (warps - 1) * nv


@pytest.mark.parametrize("d,dtype,want", [
    (2056, torch.float32, ("block", 2)), (4096, torch.float32, ("block", 2)),
    (7168, torch.float32, ("block", 4)), (16384, torch.float32, ("block", 8)),
    (16392, torch.float32, ("loop", 0)), (16392, torch.bfloat16,
                                          ("block", 5)),
    (32768, torch.bfloat16, ("block", 8)),
    (32776, torch.bfloat16, ("loop", 0))])
def test_rmsnorm_bwd_block_limit(d, dtype, want):
    """K3b's "block" reaches BWD_BLOCK_WARPS x 32 x BLOCK_NV vectors (16,384
    fp32 values, 32,768 bf16); "loop" takes the rows past that."""
    x = torch.zeros(3, d, dtype=dtype)
    assert rn_kernel.variant(x, torch.zeros(d, dtype=dtype), x) == want


def test_decode_attention_constants_match_the_cuda_source():
    """K6's warps a CTA, tile rule, cluster limit, widths and query rows, as
    ``decode_attention.cu`` defines them: the launch rule counts tiles and
    warps as the kernel does, or a CTA's span would leave slots out."""
    text = _source(da_kernel.FAMILY, "decode_attention")
    assert (_const(text, "WARPS_MIN"), _const(text, "WARPS_MAX")) \
        == da_kernel.WARPS
    assert _const(text, "TILE_BYTES") == da_kernel.TILE_BYTES
    assert _const(text, "TILE_MIN") == da_kernel.TILE_MIN
    assert _const(text, "TILE_MAX") == da_kernel.TILE_MAX
    assert _const(text, "CLUSTER_MAX") == da_kernel.CLUSTER_MAX
    assert _const(text, "D_MAX") == da_kernel.D_MAX
    assert _const(text, "G_MAX") >= max(da_kernel.GROUPS)
    argtypes = da_kernel.FAMILY.argtypes["decode_attention"]
    head = re.search(r'extern "C" int decode_attention\(([^)]*)\)', text)
    assert len(head.group(1).split(",")) == len(argtypes)


@pytest.mark.parametrize("d,size,want", [
    (16, 4, 32), (40, 1, 32), (64, 4, 16), (64, 1, 32), (112, 4, 8),
    (112, 2, 16), (112, 1, 32), (128, 4, 8), (128, 2, 16), (128, 1, 32),
    (256, 4, 8), (256, 2, 8), (256, 1, 16)])
def test_decode_attention_tile(d, size, want):
    """Slots a warp's tile: 4 KB of K rows padded to 32, 64, 128 or 256
    elements, within 8 (one mma's slots) and 32."""
    assert da_kernel.tile(d, size) == want


# (B x Hkv, D) of chip_smoke.py's DECODE_CASES: ragged, then every served
# decode shape (gemma3-1b local and global, moonshot, zamba2, musicgen,
# pixtral)
DECODE_BH = [(1 * 4, 16), (3 * 4, 40), (2 * 2, 128), (2 * 16, 128),
             (8 * 1, 256), (8 * 16, 128), (8 * 32, 112), (8 * 32, 64),
             (8 * 8, 128)]


# CTAs (at 1) and clusters of 2, 4, 8 and 16 CTAs of 4 and 8 warps a card
# of 132 SMs holds at once, as an H100 reported them for K6's instances:
# 2 CTAs of 4 warps an SM (8 warps too big), 2 of 4 or 1 of 8, 4 of 4 or 2
# of 8 (DP 64 fp8), and a card whose size-16 clusters do not launch
RESIDENT = [{4: {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}, 8: {1: 0}},
            {4: {1: 264, 2: 132, 4: 62, 8: 30, 16: 14},
             8: {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}},
            {4: {1: 528, 2: 264, 4: 124, 8: 62, 16: 28},
             8: {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}},
            {4: {1: 264, 2: 132, 4: 64, 8: 32, 16: 0},
             8: {1: 132, 2: 66, 4: 32, 8: 16, 16: 0}}]


@pytest.mark.parametrize("s", [1, 31, 32, 33, 64, 1312, 8192, 131072])
@pytest.mark.parametrize("n_bh,d", DECODE_BH)
def test_decode_attention_launch_rule_covers_every_slot(n_bh, d, s):
    """K6's warps a CTA, cluster size and spans for every cache dtype and
    card limits (``RESIDENT``): every slot in exactly one whole tile of
    exactly one CTA; C a power of two at most CLUSTER_MAX with all n_bh
    clusters on the card at once, the largest that allows and leaves no
    CTA of a cluster fewer tiles than warps; W one whose grid fits at once
    (where one does) and gives the most warps."""
    for size in (4, 2, 1):
        ts = da_kernel.tile(d, size)
        tiles = -(-s // ts)
        assert (tiles - 1) * ts < s <= tiles * ts
        for resident in RESIDENT:
            w, c = da_kernel.launch_shape(n_bh, s, ts, resident)
            assert w in da_kernel.WARPS
            assert c >= 1 and c & (c - 1) == 0 and c <= da_kernel.CLUSTER_MAX
            held = resident[w]
            fits = [x for x in da_kernel.WARPS if n_bh <= resident[x][1]]
            assert (w, c) == (4, 1) if not fits else n_bh <= held[1]
            assert c == 1 or n_bh <= held[c]
            assert c == da_kernel.cluster_size(n_bh, s, ts, w, held)
            span = da_kernel.spans(s, ts, c)
            assert len(span) == c
            assert span[0][0] == 0 and span[-1][1] == tiles
            assert all(a[1] == b[0] for a, b in zip(span, span[1:]))
            if c > 1:
                assert min(hi - lo for lo, hi in span) >= w
            bigger = 2 * c
            assert (bigger > da_kernel.CLUSTER_MAX
                    or n_bh > held.get(bigger, 0)
                    or tiles // bigger < w)
            for x in fits:              # no other W gives more warps
                cx = da_kernel.cluster_size(n_bh, s, ts, x, resident[x])
                assert x * cx <= w * c
