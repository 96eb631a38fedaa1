"""The sum-and-step wrapper (``kernels/sum_sgd``) on the CPU and the meta
device: its plain version is ``sgd_leaf(p, torch.sum(g, 0), lr)`` bit for
bit, it refuses what the kernel does not take, and it counts no launch
off the card.  The kernel itself is held bitwise to the plain version on
the card by ``chip_smoke.py``."""
import pytest
import torch

from repro_torch.kernels import sum_sgd as ss
from repro_torch.models.model_zoo import sgd_leaf

DTYPES = (torch.float32, torch.bfloat16)
# one entry; tails past the last 8-entry vector (13, 37 x 21); a stacked
# (layers, experts, rows, cols) leaf
SHAPES = ((1,), (13,), (37, 21), (2, 3, 40, 24))


def _bits(t):
    return t.reshape(-1).view(torch.int32 if t.dtype == torch.float32
                              else torch.int16)


def _operands(shape, k, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(shape, generator=g).to(dtype)
    slots = (torch.randn((k,) + shape, generator=g) * 3).to(dtype)
    return p, slots


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k", (1, 2, 5))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_route_is_the_sum_then_sgd_leaf(shape, k, dtype):
    p, slots = _operands(shape, k, dtype, seed=k)
    before = ss.launches
    keep = p.clone()
    got = ss.sum_sgd(p, slots, 0.05)
    want = sgd_leaf(p, torch.sum(slots, 0), 0.05)
    assert got.dtype == dtype and got.shape == p.shape
    assert torch.equal(_bits(got), _bits(want))    # signed zeros too
    assert torch.equal(ss.sum_sgd_plain(p, slots, 0.05), want)
    assert torch.equal(p, keep)                  # the step is functional
    assert ss.launches == before                 # no launch off the card
    if (k, dtype) == (1, torch.float32):
        # one slot is the sum itself: sgd_leaf of that slot
        assert torch.equal(got, sgd_leaf(p, slots[0], 0.05))


def test_the_sum_rounds_to_the_leaf_dtype_once():
    """bf16 slots are summed in fp32 and the sum rounded once before the
    step: here 1 + 2^-8 + 2^-8 sums to 1 + 2^-7 exactly, where rounding
    after each addition would leave 1."""
    one = torch.ones(4, dtype=torch.bfloat16)
    eps = torch.full((4,), 2.0 ** -8, dtype=torch.bfloat16)
    slots = torch.stack([one, eps, eps])
    got = ss.sum_sgd(torch.zeros(4, dtype=torch.bfloat16), slots, -1.0)
    assert torch.equal(got, torch.full((4,), 1 + 2.0 ** -7,
                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_meta_route_gives_shape_and_dtype(dtype):
    p = torch.empty((4, 20, 64, 48), dtype=dtype, device="meta")
    slots = torch.empty((2,) + tuple(p.shape), dtype=dtype, device="meta")
    before = ss.launches
    got = ss.sum_sgd(p, slots, 1e-3)
    assert got.device.type == "meta"
    assert got.shape == p.shape and got.dtype == dtype
    assert ss.launches == before


@pytest.mark.parametrize("case", ["dtype", "slot_dtype", "shape", "no_slot",
                                  "no_axis", "device", "contiguous"])
def test_refuses_what_the_kernel_does_not_take(case):
    p, slots = _operands((6, 8), 2, torch.bfloat16)
    err = ValueError
    if case == "dtype":
        p, slots, err = p.to(torch.float16), slots.to(torch.float16), \
            TypeError
    elif case == "slot_dtype":
        slots, err = slots.to(torch.float32), TypeError
    elif case == "shape":
        slots = slots[:, :, :4]
    elif case == "no_slot":
        slots = slots[:0]
    elif case == "no_axis":
        slots = slots[0]
    elif case == "device":
        p = p.to("meta")
    elif case == "contiguous":
        p = p.t()
        slots = slots.transpose(1, 2)
    with pytest.raises(err):
        ss.sum_sgd(p, slots, 0.1)



def test_sum_and_update_takes_slots_or_a_sum_made():
    """``core.distributed._sum_and_update`` takes a leaf's (K, ...) client
    buffer as K slots and a sum already made, shaped as its param, as one
    slot; it lets go of each buffer and leaves the params as they were."""
    from repro_torch.core.distributed import _sum_and_update
    params = {"w": torch.randn(6, 5).to(torch.bfloat16),
              "b": torch.randn(5)}
    _, slots = _operands((6, 5), 3, torch.bfloat16)
    made = torch.randn(5)
    keep = {k: v.clone() for k, v in params.items()}
    buffers = [made, slots]             # tree order: b, then w
    new = _sum_and_update(params, buffers, 0.1)
    assert buffers == [None, None]
    assert torch.equal(_bits(new["w"]),
                       _bits(sgd_leaf(keep["w"], torch.sum(slots, 0), 0.1)))
    assert torch.equal(_bits(new["b"]), _bits(sgd_leaf(keep["b"], made, 0.1)))
    assert all(torch.equal(params[k], keep[k]) for k in params)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_an_empty_leaf_gives_an_empty_param(dtype):
    p = torch.empty(0, 7, dtype=dtype)
    got = ss.sum_sgd(p, torch.empty(2, 0, 7, dtype=dtype), 0.1)
    assert got.shape == (0, 7) and got.dtype == dtype
