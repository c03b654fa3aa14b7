"""K11 (UTF-8 validation) through the port against the reference package.

The port's plain version ``utf8_validate_plain``, the kernel's form of
the walk ``utf8_validate_pieces_plain`` (16 B piece maps composed in
order, 512 B windows) and ``Utf8Validator(device="cpu")`` against the
reference's jitted ``Utf8Validator._impl`` (run on JAX's CPU backend
once the backend has attached) and its host oracle ``validate_bytes``,
verdict for verdict (exact: verdicts are booleans): the GOOD/BAD vectors
of tests/test_utf8_utils_script.py, seeded random bytes, L = 0, lengths
-1 and -2, unaligned and strided views, multi-byte sequences across
every piece and window boundary, and an invalid byte at every offset of
a piece. The packed maps' composition is associative, and the ASCII map
is the map of an all-ASCII piece.
"""

import random

import numpy as np
import pytest
import torch

from fluentbit_tpu.ops import device as jax_device
from fluentbit_tpu.ops import utf8 as ju
from fluentbit_tpu_torch.ops import utf8 as tu
from fluentbit_tpu_torch.ops.batch import assemble
from test_torch_gpu import straddle_rows, strict_utf8

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
    """(plain version, the CPU validator) of the port, as numpy; the
    pieces plain version must equal the plain version."""
    v = tu.Utf8Validator("cpu")
    b = torch.as_tensor(batch)
    ln = torch.as_tensor(lengths)
    plain = tu.utf8_validate_plain(v.class_map, v.trans, b, ln).numpy()
    pieces = tu.utf8_validate_pieces_plain(v.class_map, v.trans, b,
                                           ln).numpy()
    np.testing.assert_array_equal(pieces, plain)
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
    want = [v is not None and len(v) <= 32 and strict_utf8(v) for v in vals]
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


def pieces_verdicts(batch, lengths):
    v = tu.Utf8Validator("cpu")
    return tu.utf8_validate_pieces_plain(
        v.class_map, v.trans, torch.as_tensor(batch),
        torch.as_tensor(lengths)).numpy()


def check_pieces(reference, batch, lengths):
    """The pieces plain version against the reference's ``_impl`` and
    strict ``bytes.decode`` of each row's first min(length, L) bytes."""
    got = pieces_verdicts(batch, lengths)
    ref = np.asarray(reference._jit(np.asarray(batch), np.asarray(lengths)))
    np.testing.assert_array_equal(got, ref)
    L = batch.shape[1]
    want = [n >= 0 and strict_utf8(bytes(r[:min(n, L)]))
            for r, n in zip(batch, lengths)]
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
@pytest.mark.parametrize("L", [17, 300, 512, 1024])
def test_pieces_plain_random_bytes(reference, seed, L):
    """Random bytes, mostly-valid text with a spliced byte, and ASCII
    rows with a multi-byte tail, at every length class: -2, -1, 0, a
    random length, the width and past it."""
    rng = np.random.default_rng(seed * 1000 + L)
    B = 96
    batch = rng.integers(0, 256, size=(B, L), dtype=np.uint8)
    text = np.frombuffer(("aé日🎉" * L).encode()[:L], np.uint8)
    for i in range(0, B, 3):
        batch[i] = text
        batch[i, rng.integers(0, L)] = rng.integers(0, 256)
    batch[1::6] = rng.integers(0, 128, size=batch[1::6].shape,
                               dtype=np.uint8)
    lengths = rng.integers(0, L + 1, size=B).astype(np.int32)
    lengths[:6] = [-2, -1, 0, L, L + 7, 1]
    got = check_pieces(reference, batch, lengths)
    assert got.any() and not got.all()


@pytest.mark.parametrize("L", [17, 300, 512, 1024])
def test_pieces_plain_straddle_rows(reference, L):
    batch, lengths = straddle_rows(L)
    got = check_pieces(reference, batch, lengths)
    assert got.any() and not got.all()
    check(reference, batch, lengths)


@pytest.mark.parametrize("kind", [b"\x80", b"\xc0\xaf", b"\xc1\xbf",
                                  b"\xf5", b"\xff", b"\xed\xa0"])
def test_pieces_plain_invalid_byte_at_every_offset(reference, kind):
    """An invalid byte of each kind (a lone continuation, C0/C1, F5-FF,
    a surrogate's ED A0) at every offset mod 16 of a piece, in both 512 B
    windows, after valid multi-byte text; and each row cut just before
    it."""
    L = 1024
    text = ("aé日🎉" * 4).encode()
    rows, lengths = [], []
    for at in list(range(48, 80)) + list(range(496, 528)) + [L - len(kind)]:
        row = np.full(L, ord("b"), np.uint8)
        row[:len(text)] = np.frombuffer(text, np.uint8)
        row[at:at + len(kind)] = np.frombuffer(kind, np.uint8)
        rows += [row, row]
        lengths += [L, at]
    got = check_pieces(reference, np.stack(rows),
                       np.array(lengths, np.int32))
    assert not got[0::2].any() and got[1::2].all()


def random_maps(rng, n):
    """n packed maps: images drawn from every state, DEAD included."""
    images = torch.from_numpy(rng.integers(0, tu.DEAD + 1, size=(n, 8)))
    return tu.pack_maps(images)


def test_map_composition_is_associative():
    rng = np.random.default_rng(0)
    f, g, h = (random_maps(rng, 500) for _ in range(3))
    left = tu.compose_maps(tu.compose_maps(f, g), h)
    right = tu.compose_maps(f, tu.compose_maps(g, h))
    assert torch.equal(left, right)
    ident = torch.full_like(f, tu.IDENTITY_MAP)
    assert torch.equal(tu.compose_maps(ident, f), f)
    assert torch.equal(tu.compose_maps(f, ident), f)
    # composition order matters: f then g is not g then f in general
    assert not torch.equal(tu.compose_maps(f, g), tu.compose_maps(g, f))


def test_composed_piece_maps_equal_the_walk():
    """The map of a row's pieces composed in order takes OK where the
    reference's table walk of the whole row ends."""
    rng = np.random.default_rng(1)
    v = tu.Utf8Validator("cpu")
    text = np.frombuffer(("aé日🎉x" * 40).encode()[:160], np.uint8)
    rows = np.stack([text] * 64)
    rows[np.arange(64), rng.integers(0, 160, 64)] = rng.integers(0, 256, 64)
    cls = v.class_map.long()[torch.from_numpy(rows).long()]
    maps = tu.piece_maps(v.trans, cls.view(64, 10, 16))
    total = maps[:, 0]
    for k in range(1, 10):
        total = tu.compose_maps(total, maps[:, k])
    ends = tu.unpack_maps(total)[:, tu.OK].numpy()
    want = [tu.validate_bytes(bytes(r)) for r in rows]
    np.testing.assert_array_equal(ends == tu.OK, want)


def test_ascii_map_is_the_map_of_an_ascii_piece():
    v = tu.Utf8Validator("cpu")
    pieces = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, size=(50, 16)))
    maps = tu.piece_maps(v.trans, v.class_map.long()[pieces])
    assert (maps == tu.ASCII_MAP).all()
    images = tu.unpack_maps(torch.tensor(tu.ASCII_MAP))
    assert images[tu.OK] == tu.OK and (images[1:] == tu.DEAD).all()
    assert tu.unpack_maps(torch.tensor(tu.IDENTITY_MAP)).tolist() == list(
        range(8))
