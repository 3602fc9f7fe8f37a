"""The CUDA pooled-gather kernel against its plain PyTorch version, on the
card. This file imports no JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_embedding_cuda.py

Without a CUDA device the test skips (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from two_tower_recommender_model_tpu_torch.ops.embedding_kernel import (
    pooled_gather,
    pooled_gather_reference,
)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card: both table and
    output dtypes, bag lengths, sentinels, and widths and an alignment that
    take the scalar path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    for d in (128, 36, 130):  # 130 is not a multiple of 4: scalar path
        for table_dtype in (torch.float32, torch.bfloat16):
            for out_dtype in (torch.float32, torch.bfloat16):
                for bag_l in (1, 3):
                    table = torch.from_numpy(rng.normal(size=(500, d)).astype(np.float32))
                    table = table.to(dev, table_dtype)
                    ids = rng.integers(-5, 520, (300, bag_l)).astype(np.int32)  # with sentinels
                    w = (rng.random((300, bag_l)) * (rng.random((300, bag_l)) > 0.2))
                    ids_t = torch.from_numpy(ids).to(dev)
                    w_t = torch.from_numpy(w.astype(np.float32)).to(dev)
                    before = pooled_gather.launches
                    got = pooled_gather(table, ids_t, w_t, out_dtype)
                    want = pooled_gather_reference(table, ids_t, w_t, out_dtype)
                    torch.cuda.synchronize()
                    assert pooled_gather.launches == before + 1
                    if bag_l == 1:
                        assert torch.equal(got, want)
                    else:
                        tol = 1e-5 if out_dtype == torch.float32 else 1e-2
                        torch.testing.assert_close(got.float(), want.float(),
                                                   rtol=tol, atol=tol)
    # a table 4 bytes off 16-byte alignment takes the scalar path
    storage = torch.empty(500 * 128 + 1, device=dev)
    table = storage[1:].view(500, 128)
    table.copy_(torch.from_numpy(rng.normal(size=(500, 128)).astype(np.float32)))
    ids_t = torch.from_numpy(rng.integers(0, 500, (300, 1)).astype(np.int32)).to(dev)
    w_t = torch.ones((300, 1), device=dev)
    assert torch.equal(pooled_gather(table, ids_t, w_t), pooled_gather_reference(table, ids_t, w_t))
