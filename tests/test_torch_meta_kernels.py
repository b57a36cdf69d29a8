"""The kernel wrappers' ``meta`` branch: a plan of a card launch.

On ``meta`` tensors each wrapper (K3 / K3b, K4 / K4b, K5 / K5b, K6 and its
partial form) runs the card path's checks and returns empty outputs of the
card's shapes and dtypes; it computes nothing and launches nothing.

* On the CPU: every case's meta outputs have the plain version's shapes
  and dtypes (where the plain version returns the output: K5's saved
  states exist only on the card), no launch is counted, and every input
  the card path refuses (dtype, stride, head width, GQA group, state size,
  a missing saved state) is refused on meta with the card path's message.
* On the card (``cuda`` marker): the meta outputs have the shapes and
  dtypes of the card's own outputs, K5's saved states included, and the
  card refuses each refused input with the same message.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as da
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.rmsnorm import kernel as rn
from repro_torch.kernels.selective_scan import kernel as ss


def _rand(device, *shape, dtype=torch.float32):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=g, dtype=torch.float32) \
        .to(dtype).to(device)


def _args(case: str, device, dtype=torch.float32):
    """(wrapper, args, kwargs) of one case on ``device``."""
    r = lambda *s: _rand(device, *s, dtype=dtype)          # noqa: E731
    f = lambda *s: _rand(device, *s)                       # noqa: E731
    if case == "rmsnorm":
        return rn.rmsnorm_rows, (r(10, 48), r(48)), {}
    if case == "rmsnorm_split":
        return rn.rmsnorm_rows, (r(10, 48), r(48), 1e-6, f(10).abs(), 96), {}
    if case == "rmsnorm_bwd":
        return rn.rmsnorm_rows_bwd, (r(10, 48), r(48), r(10, 48)), {}
    if case == "rmsnorm_bwd_split":
        return rn.rmsnorm_rows_bwd, (r(10, 48), r(48), r(10, 48), 1e-6,
                                     f(10).abs(), 96), {}
    if case == "flash_attention":
        return fa.flash_attention, (r(2, 4, 9, 32), r(2, 2, 9, 32),
                                    r(2, 2, 9, 32)), dict(scale=0.2)
    if case == "flash_attention_lse":
        return fa.flash_attention, (r(2, 4, 9, 32), r(2, 2, 9, 32),
                                    r(2, 2, 9, 32)), dict(scale=0.2,
                                                          window=4,
                                                          with_lse=True)
    if case == "flash_attention_bwd":
        q, k, v = r(2, 4, 9, 32), r(2, 2, 9, 32), r(2, 2, 9, 32)
        return fa.flash_attention_bwd, (q, k, v, r(2, 4, 9, 32),
                                        f(2, 4, 9), r(2, 4, 9, 32)), \
            dict(scale=0.2)
    if case in ("selective_scan", "selective_scan_states"):
        return ss.selective_scan, (f(2, 20, 8), f(2, 20, 8), f(2, 20, 4),
                                   f(2, 20, 4), -f(8, 4).abs(), f(2, 8, 4),
                                   f(8), f(2, 20, 8)), \
            dict(states=case.endswith("states"))
    if case == "decode_attention":
        return da.decode_attention, (f(2, 4, 1, 32), r(2, 2, 12, 32),
                                     r(2, 2, 12, 32), 7), dict(window=5)
    if case == "decode_attention_partial":
        return da.decode_attention, (f(2, 4, 1, 32), r(2, 2, 6, 32),
                                     r(2, 2, 6, 32), 9), \
            dict(slots=(6, 12))
    raise KeyError(case)


CASES = ("rmsnorm", "rmsnorm_split", "rmsnorm_bwd", "rmsnorm_bwd_split",
         "flash_attention", "flash_attention_lse", "flash_attention_bwd",
         "selective_scan", "selective_scan_states", "decode_attention",
         "decode_attention_partial")


def _signature(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [None if t is None else (tuple(t.shape), t.dtype) for t in outs]


def _launches():
    return {**rn.launches, **fa.launches, **ss.launches, **da.launches}


@pytest.mark.parametrize("case", CASES)
def test_meta_branch_gives_the_plain_versions_shapes(case):
    fn, args, kw = _args(case, "cpu")
    want = _signature(fn(*args, **kw))
    before = _launches()
    fn_m, args_m, kw_m = _args(case, "meta")
    got = fn_m(*args_m, **kw_m)
    assert all(t is None or t.device.type == "meta"
               for t in (got if isinstance(got, tuple) else (got,)))
    if case == "selective_scan_states":
        # the plain version keeps no states; the card's are (B, ceil(S /
        # 16), d, N)
        assert want[2] is None
        want[2] = ((2, 2, 8, 4), torch.float32)
    assert _signature(got) == want
    assert _launches() == before


def _refused(device):
    """(case, call) pairs the card path refuses, on ``device``."""
    f = lambda *s: _rand(device, *s)                       # noqa: E731
    h = lambda *s: _rand(device, *s, dtype=torch.float16)  # noqa: E731
    q, k = f(1, 2, 4, 288), f(1, 2, 4, 288)
    scan = (f(1, 4, 8), f(1, 4, 8), f(1, 4, 32), f(1, 4, 32),
            f(8, 32), f(1, 8, 32))
    return {
        "rmsnorm fp16": lambda: rn.rmsnorm_rows(h(4, 8), h(8)),
        "rmsnorm strided": lambda: rn.rmsnorm_rows(f(8, 4).T, f(8)),
        "rmsnorm_bwd g dtype": lambda: rn.rmsnorm_rows_bwd(
            f(4, 8), f(8), f(4, 8).double()),
        "flash_attention D > 256": lambda: fa.flash_attention(
            q, k, k, scale=1.0),
        "flash_attention fp16": lambda: fa.flash_attention(
            h(1, 2, 4, 8), h(1, 2, 4, 8), h(1, 2, 4, 8), scale=1.0),
        "flash_attention strided": lambda: fa.flash_attention(
            f(1, 2, 8, 4).transpose(2, 3), f(1, 2, 4, 8), f(1, 2, 4, 8),
            scale=1.0),
        "selective_scan N > 16": lambda: ss.selective_scan(*scan),
        "selective_scan non-contiguous": lambda: ss.selective_scan(
            f(1, 8, 4).transpose(1, 2), f(1, 4, 8), f(1, 4, 2), f(1, 4, 2),
            f(8, 2), f(1, 8, 2)),
        "selective_scan_bwd without states": lambda: ss.selective_scan_bwd(
            f(1, 4, 8), f(1, 4, 8), f(1, 4, 2), f(1, 4, 2), f(8, 2),
            f(1, 8, 2), None, f(1, 4, 8)),
        "decode_attention group 3": lambda: da.decode_attention(
            f(1, 3, 1, 8), f(1, 1, 4, 8), f(1, 1, 4, 8), 2),
        "decode_attention D > 256": lambda: da.decode_attention(
            f(1, 2, 1, 288), f(1, 2, 4, 288), f(1, 2, 4, 288), 2),
        "decode_attention non-contiguous": lambda: da.decode_attention(
            f(1, 2, 1, 8), f(1, 2, 8, 4).transpose(2, 3), f(1, 2, 4, 8), 2),
    }


REFUSED = tuple(_refused("cpu"))


@pytest.mark.parametrize("case", REFUSED)
def test_meta_branch_refuses_what_the_card_refuses(case):
    with pytest.raises(ValueError):
        _refused("meta")[case]()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_meta_branch_gives_the_cards_shapes(cuda, case):
    fn, args, kw = _args(case, cuda)
    want = _signature(fn(*args, **kw))
    fn_m, args_m, kw_m = _args(case, "meta")
    assert _signature(fn_m(*args_m, **kw_m)) == want


@pytest.mark.cuda
@pytest.mark.parametrize("case", REFUSED)
def test_card_refuses_what_the_meta_branch_refuses(cuda, case):
    with pytest.raises(ValueError) as on_card:
        _refused(cuda)[case]()
    with pytest.raises(ValueError) as on_meta:
        _refused("meta")[case]()
    assert str(on_meta.value).replace("meta", "DEV") == \
        str(on_card.value).replace("cuda:0", "DEV").replace("cuda", "DEV")
