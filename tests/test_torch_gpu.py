"""The grep_dfa CUDA kernel against its plain torch version (needs a card).

Every test here is marked ``gpu`` and skips itself, in the
``cuda_device`` fixture, where ``torch.cuda.is_available()`` is false: a
CUDA kernel has no CPU mode. This file imports neither JAX nor the
reference package, so it runs on a GPU host that has only the port's
dependencies:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import random

import numpy as np
import pytest
import torch

from fluentbit_tpu_torch.ops import grep as tg
from fluentbit_tpu_torch.regex.dfa import compile_dfa

APACHE2 = (
    r'^(?<host>[^ ]*) [^ ]* (?<user>[^ ]*) \[(?<time>[^\]]*)\] '
    r'"(?<method>\S+)(?: +(?<path>[^ ]*) +\S*)?" '
    r'(?<code>[^ ]*) (?<size>[^ ]*)'
    r'(?: "(?<referer>[^\"]*)" "(?<agent>.*)")?$'
)
MIXED_K = [APACHE2, "GET", r"^\d+ GET"]  # k = 3, 6, 5: three children


def make_lines(n, seed):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        if rng.random() < 0.6:
            out.append(f'10.0.0.{i} - u{i} [10/Oct/2024:13:55:36 -0700] '
                       f'"GET /p/ü{i} HTTP/1.1" 200 {rng.randrange(999)}'
                       .encode())
        else:
            out.append(f"{i} GET junk 日本".encode())
    return out


def random_rows(rng, R, B, L):
    """Seeded rows: random bytes (non-ASCII included), every length
    class: -1, -2, 0, odd/even, L-1 and L."""
    batch = rng.integers(0, 256, size=(R, B, L), dtype=np.uint8)
    lengths = rng.integers(-2, L + 1, size=(R, B)).astype(np.int32)
    special = np.array([-1, -2, 0, 1, L - 1, L], dtype=np.int32)
    lengths[:, : min(B, len(special))] = special[: min(B, len(special))]
    return batch, lengths


def full_tables(prog, device):
    """Every table of ``prog``'s rules on ``device``, ``pair_maps`` too."""
    return {name: torch.from_numpy(a).to(device)
            for name, a in tg.build_tables(prog.dfas, prog.k).items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grep_dfa kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("patterns,L", [([APACHE2], 512), ([APACHE2], 45),
                                        (["GET", "DENY"], 64),
                                        (MIXED_K, 128), (MIXED_K, 0)])
@pytest.mark.parametrize("B", [1, 17, 300])
def test_cuda_kernel_equals_plain(cuda_device, patterns, L, B):
    prog = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L,
                               cuda_device)
    batch, lengths = random_rows(np.random.default_rng(B + L), len(patterns),
                                 B, L)
    lines = make_lines(min(B, 40), seed=B)
    for i, ln in enumerate(lines):
        if len(ln) <= L:
            batch[:, i, :] = 0
            batch[:, i, : len(ln)] = np.frombuffer(ln, np.uint8)
            lengths[:, i] = len(ln)
    before = tg.grep_dfa.launches
    got = prog.match(batch, lengths)
    assert tg.grep_dfa.launches - before == len(prog.decision()["k_groups"])
    cpu = tg.TorchGrepProgram([compile_dfa(p) for p in patterns], L, "cpu")
    np.testing.assert_array_equal(got, cpu.match(batch, lengths))
    if prog.tables is not None:  # plain version on the card, same inputs
        # the device program holds only the kernel's tables; the plain
        # version gets the full set, so even k takes K2's pair tables
        assert "pair_maps" not in prog.tables
        plain = tg.match_plain(full_tables(prog, cuda_device),
                               torch.from_numpy(batch).cuda(),
                               torch.from_numpy(lengths).cuda(), prog.k)
        np.testing.assert_array_equal(got, plain.cpu().numpy())


@pytest.mark.gpu
def test_cuda_kernel_unaligned_batch(cuda_device):
    """A batch view at an odd offset takes the byte-load path."""
    prog = tg.TorchGrepProgram([compile_dfa(APACHE2)], 64, cuda_device)
    batch, lengths = random_rows(np.random.default_rng(1), 1, 50, 64)
    flat = torch.zeros(1 + batch.size, dtype=torch.uint8, device=cuda_device)
    view = flat[1:].view(1, 50, 64)
    view.copy_(torch.from_numpy(batch))
    lt = torch.from_numpy(lengths).cuda()
    got = tg.grep_dfa(prog.tables, view, lt, prog.k)
    plain = tg.match_plain(prog.tables, view, lt, prog.k)
    assert torch.equal(got, plain)
