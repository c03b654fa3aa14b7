"""K11 (UTF-8 validation) through the port against the reference package.

The port's plain version ``utf8_validate_plain`` and its
``Utf8Validator(device="cpu")`` against the reference's jitted
``Utf8Validator._impl`` (run on JAX's CPU backend once the backend has
attached) and its host oracle ``validate_bytes``, verdict for verdict
(exact: verdicts are booleans): the GOOD/BAD vectors of
tests/test_utf8_utils_script.py, seeded random bytes, L = 0, lengths -1
and -2, and unaligned and strided views.
"""

import random

import numpy as np
import pytest
import torch

from fluentbit_tpu.ops import device as jax_device
from fluentbit_tpu.ops import utf8 as ju
from fluentbit_tpu_torch.ops import utf8 as tu
from fluentbit_tpu_torch.ops.batch import assemble

GOOD = [
    b"plain ascii",
    "héllo wörld".encode(),
    "日本語テキスト".encode(),
    "🎉🚀 emoji".encode(),
    "\U0010FFFF".encode(),  # max code point
    b"",
]
BAD = [
    b"\x80midstream",            # lone continuation
    b"\xc0\xaf",                 # overlong '/'
    b"\xc1\xbf",                 # C1 always invalid
    b"\xe0\x80\x80",             # overlong 3-byte
    b"\xed\xa0\x80",             # UTF-16 surrogate D800
    b"\xf0\x80\x80\x80",         # overlong 4-byte
    b"\xf4\x90\x80\x80",         # > U+10FFFF
    b"\xf5\x80\x80\x80",         # F5 lead invalid
    b"truncated \xe6\x97",       # cut sequence
    b"\xff",
]


@pytest.fixture(scope="module")
def reference():
    """The reference validator with its jitted ``_impl`` attached (the
    first calls would otherwise serve the host DFA)."""
    assert jax_device.wait()
    v = ju.Utf8Validator()
    assert v._ensure_device()
    assert v._jit is not None
    return v


def port_verdicts(batch, lengths):
    """(plain version, the CPU validator) of the port, as numpy."""
    v = tu.Utf8Validator("cpu")
    b = torch.as_tensor(batch)
    ln = torch.as_tensor(lengths)
    plain = tu.utf8_validate_plain(v.class_map, v.trans, b, ln).numpy()
    return plain, v.validate(batch, lengths)


def check(reference, batch, lengths, want=None):
    before = tu.utf8_validate.launches
    plain, port = port_verdicts(batch, lengths)
    ref = np.asarray(reference._jit(np.asarray(batch), np.asarray(lengths)))
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(port, ref)
    if want is not None:
        np.testing.assert_array_equal(port, want)
    assert tu.utf8_validate.launches == before  # CPU tensors: no kernel
    return port


def test_tables_equal_reference():
    np.testing.assert_array_equal(tu._CLS, ju._CLS)
    np.testing.assert_array_equal(tu._TRANS, ju._TRANS)
    assert (tu._TRANS[tu.DEAD] == tu.DEAD).all()  # DEAD is absorbing


def test_oracle_equals_reference():
    for v in GOOD + BAD:
        assert tu.validate_bytes(v) == ju.validate_bytes(v), v


@pytest.mark.parametrize("width", [64, 16, 11])
def test_good_bad_vectors(reference, width):
    vals = GOOD + BAD
    staged = assemble(vals, width)
    want = [ju.validate_bytes(v) if len(v) <= width else False for v in vals]
    check(reference, staged.batch, staged.lengths, want)


@pytest.mark.parametrize("seed", [1, 2])
def test_random_bytes_equal_stdlib(reference, seed):
    rng = random.Random(seed)
    vals = []
    for i in range(300):
        n = rng.randrange(40)
        if i % 3:
            raw = bytes(rng.randrange(256) for _ in range(n))
        else:  # mostly valid text with a random byte spliced in
            text = "aé日🎉"[rng.randrange(4)] * rng.randrange(1, 8)
            raw = bytearray(text.encode())
            raw.insert(rng.randrange(len(raw) + 1), rng.randrange(256))
            raw = bytes(raw)
        vals.append(raw)
    vals += [None, b"x" * 40]  # a missing value (-1), an overflow row (-2)
    staged = assemble(vals, 32)
    assert staged.lengths[-2:].tolist() == [-1, -2]

    def strict(v):
        try:
            v.decode("utf-8")
            return True
        except UnicodeDecodeError:
            return False

    want = [v is not None and len(v) <= 32 and strict(v) for v in vals]
    check(reference, staged.batch, staged.lengths, want)


def test_zero_width_and_negative_lengths(reference):
    batch = np.zeros((5, 0), dtype=np.uint8)
    lengths = np.array([0, -1, -2, 0, 3], dtype=np.int32)
    check(reference, batch, lengths, [True, False, False, True, True])
    batch = np.full((4, 8), 0xE6, dtype=np.uint8)  # bytes past len ignored
    lengths = np.array([-1, -2, 0, 8], dtype=np.int32)
    check(reference, batch, lengths, [False, False, True, False])


def test_unaligned_and_strided_views(reference):
    rng = np.random.default_rng(3)
    rows = [bytes(rng.integers(0, 128, size=n, dtype=np.uint8))
            + "ü".encode() * (n % 3) for n in range(40)]
    rows[5] += b"\xe6\x97"
    staged = assemble(rows, 48)
    flat = torch.zeros(1 + staged.batch.size, dtype=torch.uint8)
    unaligned = flat[1:].view(staged.batch.shape)
    unaligned.copy_(torch.from_numpy(staged.batch))
    want = check(reference, staged.batch, staged.lengths)
    plain, port = port_verdicts(unaligned, torch.from_numpy(staged.lengths))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(port, want)
    wide = torch.zeros((staged.batch.shape[0], 96), dtype=torch.uint8)
    wide[:, ::2] = torch.from_numpy(staged.batch)
    strided = wide[:, ::2]
    assert not strided.is_contiguous()
    _, port = port_verdicts(strided, torch.from_numpy(staged.lengths))
    np.testing.assert_array_equal(port, want)


def test_validator_is_cached_per_device():
    assert tu.validator("cpu") is tu.validator(torch.device("cpu"))
    assert tu.validator("cpu").device == torch.device("cpu")


def test_kernel_wrapper_refuses_cpu_tensors():
    v = tu.Utf8Validator("cpu")
    batch = torch.zeros((2, 16), dtype=torch.uint8)
    lengths = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tu.utf8_validate(v.class_map, v.trans, batch, lengths)
