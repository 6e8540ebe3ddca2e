"""The port's CUDA kernels against their plain PyTorch versions on the
card, bit for bit. They need an NVIDIA card and nvcc and skip without
them. The repository's conftest imports JAX, which the card's machine
need not have, so run them there without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from text_crdt_rust_tpu_torch.ops import _kernels
from text_crdt_rust_tpu_torch.ops import batch as TB
from text_crdt_rust_tpu_torch.ops import rle as TR
from text_crdt_rust_tpu_torch.utils import randedit
from text_crdt_rust_tpu_torch.utils.testdata import TestPatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _compile(patches, fuse_w=1):
    merged = TB.merge_patches(patches)
    lmax = max([len(p.ins_content) for p in merged] + [1])
    ops, _ = TB.compile_local_patches(merged, lmax=lmax, fuse_w=fuse_w)
    if fuse_w > 1:
        ops, _ = TB.fuse_steps(ops, fuse_w=fuse_w)
    return ops


def _random(seed, steps=200):
    return _compile(randedit.random_patches(np.random.default_rng(seed),
                                            steps)[0])


CASES = {
    "random-k8": lambda: ([_random(1)], dict(capacity=512, block_k=8)),
    "random-k16-b40": lambda: ([_random(2)],
                               dict(capacity=512, block_k=16, batch=40)),
    "bursts-w8-k32": lambda: ([_compile(randedit.prepend_bursts(
        np.random.default_rng(3), 30)[0], fuse_w=8)],
        dict(capacity=1024, block_k=32)),
    "groups-3": lambda: ([_random(4), _random(5, 100), _random(6, 50)],
                         dict(capacity=512, block_k=8)),
    "capacity-overflow": lambda: (
        [_compile([TestPatch(0, 0, "ab")] * 40)], dict(capacity=16, block_k=8)),
    "bad-delete": lambda: (
        [_compile([TestPatch(0, 0, "abc"), TestPatch(0, 10, "")])],
        dict(capacity=32, block_k=8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain(card, name):
    streams, shape = CASES[name]()
    shape.setdefault("batch", 8)
    rep = TR.make_replayer_rle(streams, device=card, chunk=128, **shape)
    plain = TR.rle_replay_plain(*rep.staged, **rep.shape)
    before = _kernels.launches.get("rle_replay", 0)
    kern = TR.rle_replay_cuda(*rep.staged, **rep.shape)
    torch.cuda.synchronize()
    assert _kernels.launches["rle_replay"] == before + 1
    for k, p in zip(kern, plain):
        assert k.dtype == p.dtype and k.shape == p.shape
        assert torch.equal(k, p)
