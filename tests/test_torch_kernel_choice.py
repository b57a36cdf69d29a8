"""Which instance or variant of K4 ``flash_attention`` and K3 ``rmsnorm``
a call takes, decided on the host before the launch (so checked here on
the CPU), and the constants the wrappers share with the CUDA sources,
read from the ``.cu`` files: a mismatch would have the card refuse every
launch or cover a row only in part."""
import re

import pytest
import torch

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


def _k3b_rule(x, scale, g) -> tuple:
    """K3b's variant rule, written out: "scalar" unless x, g and scale are
    16-byte aligned, then "warp" up to D_MAX and "loop" past it, whatever
    the row count."""
    d = x.shape[1]
    size = x.element_size()
    epv = 16 // size
    aligned = (d % epv == 0 and scale.data_ptr() % 16 == 0
               and all(t.stride(0) * size % 16 == 0 and t.data_ptr() % 16 == 0
                       for t in (x, g)))
    if not aligned:
        return "scalar", 0
    if d > rn_kernel.D_MAX:
        return "loop", 0
    return "warp", -(-d // (32 * epv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 64), (8, 1152), (8, 2048),
                                    (8, 4096), (8, 7168), (9, 2056),
                                    (300, 256), (4096, 1152),
                                    (4096, 3584), (16384, 256)])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_bwd_choice_is_unchanged(dtype, rows, d, offset):
    """K3b (``variant`` given g) keeps its own rule: the few rows and wide
    rows that K3 now spreads over a block stay "warp" / "loop" for K3b,
    whose redesign is its own."""
    buf = torch.zeros(rows * d + offset, dtype=dtype)
    x = buf[offset:].view(rows, d)
    g = torch.zeros(rows, d, dtype=dtype)
    s = torch.zeros(d, dtype=dtype)
    assert rn_kernel.variant(x, s, g) == _k3b_rule(x, s, g)
