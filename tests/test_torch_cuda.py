"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports neither JAX nor the reference package, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every kernel equals its plain version bit for bit: K1, K2 and K7 by
construction (integer work, or one rounding per element); K4 and K6
because both sides take their sums in float64 and every division, sqrt
and exp in float64, each rounded once to fp32.  Without a card each test
skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _i8(g, shape, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.cuda
def test_cuda_qmatmul_quantize_gather_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    for m, k, n in ((4, 4096, 1024), (16, 256, 72), (5, 100, 30)):
        a, b = _i8(g, (m, k), cuda), _i8(g, (k, n), cuda)
        assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
        inv = torch.tensor(2.0 ** -12, device=cuda)
        assert torch.equal(ops.qmatmul(a, b, inv), ref.qmatmul(a, b, inv))
        x = torch.randn((m, k), generator=g, device=cuda)
        assert torch.equal(ops.quantize(x, 32.0), ref.quantize(
            x, torch.tensor(32.0, device=cuda)))
    a, b = _i8(g, (8, 48, 128), cuda), _i8(g, (8, 128, 40), cuda)
    assert torch.equal(ops.qmatmul(a, b), ref.qmatmul(a, b))
    pages = _i8(g, (9, 16, 8, 128), cuda)
    table = torch.tensor([[3, 0, 12], [-1, 8, 2]], device=cuda,
                         dtype=torch.int32)               # ids clamp
    assert torch.equal(ops.page_gather(pages, table),
                       ref.page_gather(pages, table))


@pytest.mark.cuda
def test_cuda_ubn_and_paged_attention_bitwise(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((64, 4096), generator=g, device=cuda)
    gamma = 1.0 + 0.1 * torch.randn(4096, generator=g, device=cuda)
    beta = 0.1 * torch.randn(4096, generator=g, device=cuda)
    assert torch.equal(ops.ubn_norm(x, gamma), ref.ubn_norm(x, gamma))
    assert torch.equal(ops.ubn_norm(x, gamma, beta, kind="layer"),
                       ref.ubn_norm(x, gamma, beta, kind="layer"))
    # 4 lanes of 32 query / 8 KV heads of 128 over ragged contexts; lane 0
    # is dead (its table row is the trash page 0)
    r = np.random.default_rng(2)
    kp, vp = (torch.from_numpy(r.integers(-127, 128, (33, 16, 8, 128))
                               .astype(np.int8)).to(cuda) for _ in range(2))
    q8 = torch.from_numpy(r.integers(-127, 128, (4, 32, 128))
                          .astype(np.int8)).to(cuda)
    table = torch.zeros((4, 8), dtype=torch.int32)
    table[1:, :] = torch.arange(1, 25, dtype=torch.int32).reshape(3, 8)
    q_pos = torch.tensor([0, 17, 127, 60], dtype=torch.int32)
    args = (q8, kp, vp, table.to(cuda), q_pos.to(cuda), 128,
            *(torch.tensor(s, device=cuda)
              for s in (2.0 ** -6, 2.0 ** -7, 2.0 ** -7)))
    pk = ops.paged_attention_parts(*args, sm_scale=128 ** -0.5)
    pp = ref.paged_attention_parts(*args, sm_scale=128 ** -0.5)
    for part in ("m", "l", "p8", "out"):
        assert torch.equal(pk[part], pp[part]), part
