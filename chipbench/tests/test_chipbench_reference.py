"""The plain reference on small hand-made cases, and against the program
at a small size (the program is only the witness here; the reference never
imports it)."""
import math
import pathlib
import struct
import sys

import numpy as np
import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent / "src"))
sys.path.insert(0, str(HERE.parent))

from reference import ckks, fedavg, frames, threefry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def negacyclic(a, b, q):
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k, s = (i + j) % n, 1 if i + j < n else -1
            out[k] = (out[k] + s * a[i] * b[j]) % q
    return out


def test_moduli_are_ntt_primes():
    from repro_torch.core.ckks import params

    qs = ckks.moduli(8192, 2, 30)
    assert qs == (1073692673, 1073643521)
    assert list(qs) == params.find_ntt_primes(8192, 2, 30)
    for q in qs:
        assert ckks.is_prime(q) and q % (2 * 8192) == 1 and q < 2 ** 30


def test_ntt_inverts_and_multiplies_negacyclically():
    ring = ckks.Ring(8, 2, 30, "cpu")
    g = torch.Generator().manual_seed(3)
    q = ring.q[:, None]
    a = torch.randint(0, 2 ** 29, (2, 2, 8), generator=g) % q
    b = torch.randint(0, 2 ** 29, (2, 2, 8), generator=g) % q
    assert torch.equal(ring.intt(ring.ntt(a)), a)
    prod = ring.intt(ring.ntt(a) * ring.ntt(b) % q)
    for r in range(2):
        for l, ql in enumerate(ring.primes):
            assert prod[r, l].tolist() == negacyclic(
                a[r, l].tolist(), b[r, l].tolist(), ql)


def test_decode_of_a_constant_and_of_a_negative():
    ring = ckks.Ring(8, 2, 30, "cpu")
    scale = 2.0 ** 20
    for v in (0.75, -1.5):
        c = torch.zeros(1, 2, 8, dtype=torch.int64)
        c[0, :, 0] = torch.tensor([int(round(v * scale)) % q
                                   for q in ring.primes])
        z = ring.decode(c, scale)
        assert torch.allclose(z, torch.full((1, 4), v, dtype=torch.float64))


def test_decrypt_of_a_hand_made_ciphertext():
    """c0 = -a s + m, c1 = a decrypts to m (noise-free)."""
    ring = ckks.Ring(8, 2, 30, "cpu")
    q = ring.q[:, None]
    s = ring.residues(torch.tensor([1, 0, -1, 1, 0, 0, -1, 1]))
    m = ring.residues(torch.tensor([5, -3, 0, 2, 0, 1, 0, -7]))
    a = torch.arange(16, dtype=torch.int64).view(2, 8) * 7919 % q
    s_ntt = ring.ntt(s[None])[0]
    c0 = (ring.ntt(m[None])[0] - a * s_ntt) % q
    got = ring.decrypt(c0[None], a[None], s_ntt)[0]
    assert torch.equal(got, m)


def test_threefry_known_answers():
    """Random123's Threefry-2x32-20 known-answer vectors."""
    t = lambda *w: torch.tensor(w, dtype=torch.int64)  # noqa: E731
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for key, ctr, want in cases:
        y = threefry._block(t(key[0]), t(key[1]), t(ctr[0]), t(ctr[1]))
        assert (int(y[0]), int(y[1])) == want


def test_a_rows_equal_the_programs_stream():
    from repro_torch.core.ckks import cipher, params

    ctx = params.make_test_context(n_poly=64, device="cpu")
    for seed in (0, 12345, 2 ** 31 - 1):
        want = cipher.expand_a_rows(ctx, seed, 0, 5).to(torch.int64)
        got = threefry.a_rows(seed, torch.arange(5), ctx.primes, 64)
        assert torch.equal(got, want)


def test_ring_matches_the_programs_ntt_and_decrypt():
    from repro_torch.core.ckks import cipher, params
    from repro_torch.kernels import ops

    ctx = params.make_test_context(n_poly=256, device="cpu")
    ring = ckks.Ring(256, 2, 30, "cpu")
    assert ring.primes == tuple(ctx.primes)
    g = torch.Generator().manual_seed(1)
    x = cipher.sample_uniform(g, (3, 256), ctx)
    assert torch.equal(ring.ntt(x.to(torch.int64)),
                       ops.ntt_fwd(x, ctx).to(torch.int64))
    s = cipher.sample_ternary(g, (256,), "cpu")
    a = cipher.sample_uniform(g, (256,), ctx)
    e = cipher.sample_gaussian(g, (256,), "cpu", 3.2)
    _, pk = cipher.keygen_from_samples(ctx, s, a, e)
    vals = torch.randn(4, 128, generator=g)
    ct = cipher.encrypt_values(ctx, pk, vals, g)
    s_ntt = ring.ntt(ring.residues(s)[None])[0]
    z = ckks.decrypt_decode(ring, ct.data[:, :, 0], ct.data[:, :, 1], s_ntt,
                            ct.scale, block_rows=3)
    assert float((z - vals.double()).abs().max()) < 1e-2


def test_top_p_mask_breaks_ties_by_index():
    s = torch.tensor([0.5, -0.9, 0.5, 0.1, 0.5])
    assert fedavg.top_p_mask(s, 0.4).tolist() == [True, True, False, False,
                                                  False]
    assert fedavg.top_p_mask(s, 0.0).sum() == 0
    assert fedavg.top_p_mask(s, 1.0).all()


def test_top_p_mask_equals_the_programs():
    from repro_torch.core import selection

    g = torch.Generator().manual_seed(5)
    s = torch.randint(0, 50, (4000,), generator=g).float() / 7
    for p in (0.01, 0.1, 0.37):
        assert torch.equal(fedavg.top_p_mask(s, p),
                           selection.top_p_mask(s, p))


def test_weighted_mean_and_error():
    xs = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 6.0])]
    m = fedavg.weighted_mean(iter(xs), [0.25, 0.75])
    assert m.tolist() == [2.5, 5.0]
    assert fedavg.max_abs_err(torch.tensor([2.5, 5.5]), m) == 0.5
    assert fedavg.max_abs_err(torch.tensor([2.5, float("nan")]), m) \
        == float("inf")


def _frame(ftype, payload, version=2):
    return struct.pack("<4sBBHQ", b"RPWR", version, ftype, 0,
                       len(payload)) + payload


def _array(a):
    a = np.ascontiguousarray(a)
    code = {np.dtype(np.uint32): 0, np.dtype(np.float32): 1,
            np.dtype(np.float16): 2}[a.dtype]
    return struct.pack("<BB", code, a.ndim) + struct.pack(
        f"<{a.ndim}I", *a.shape) + a.tobytes()


def test_parse_a_hand_made_downlink():
    ct = np.arange(3 * 2 * 2 * 8, dtype=np.uint32).reshape(3, 2, 2, 8)
    plain = np.array([1.5, -2.0], np.float32)
    blob = _frame(0x03, _frame(0x01, struct.pack("<d", 2.0 ** 52)
                               + _array(ct))
                  + _frame(0x08, struct.pack("<Bd", 0, 1.0)
                           + _array(plain)))
    assert len(blob) == frames.downlink_bytes(3, 2, 8, 2)
    d = frames.parse_downlink(blob)
    assert d["scale"] == 2.0 ** 52 and d["codec"] == "f32"
    assert np.array_equal(d["ct"], ct) and np.array_equal(d["plain"], plain)
    with pytest.raises(frames.LayoutError):
        frames.parse_downlink(blob[:-1])


def test_parse_a_hand_made_uplink():
    c0 = [np.full((1, 2, 8), b, np.uint32) for b in range(2)]
    chunks = [_frame(0x07, struct.pack("<I", b) + _frame(
        0x02, struct.pack("<dQIB", 2.0 ** 26, 99, b, 1) + _array(c0[b])))
        for b in range(2)]
    plain = np.array([0.5, 0.25, -1.0], np.float16)
    blob = (_frame(0x06, struct.pack("<IIIIB", 7, 30, 4, 2, 1))
            + b"".join(chunks)
            + _frame(0x08, struct.pack("<Bd", 2, 1.0) + _array(plain))
            + _frame(0x09, b""))
    assert len(blob) == frames.uplink_bytes(2, 2, 8, 3, "f16")
    u = frames.parse_uplink(blob)
    assert u["begin"] == (7, 30, 4, 2, 1) and u["end"]
    assert [r[:6] for r in u["rows"]] == [(b, 2.0 ** 26, 99, b, 1, 2)
                                          for b in range(2)]
    assert u["codec"] == "f16" and np.array_equal(u["plain"], plain)


def test_layout_counts_equal_the_programs_blobs():
    from repro_torch.core.ckks import cipher, params
    from repro_torch.core.secure_agg import ProtectedUpdate
    from repro_torch.wire import compress, stream
    from repro_torch.wire import format as wf

    ctx = params.make_test_context(n_poly=64, device="cpu")
    g = torch.Generator().manual_seed(2)
    s = cipher.sample_ternary(g, (64,), "cpu")
    a = cipher.sample_uniform(g, (64,), ctx)
    e = cipher.sample_gaussian(g, (64,), "cpu", 3.2)
    sk, _ = cipher.keygen_from_samples(ctx, s, a, e)
    ct = cipher.encrypt_values_seeded(ctx, sk, torch.randn(3, 32), g, 77)
    upd = ProtectedUpdate(ct=ct, plain=torch.randn(11))
    for codec in ("f32", "f16", "i8"):
        up = stream.pack_update_frames(
            upd, cid=1, n_samples=2, seeded=compress.seed_compress(ct, 77),
            plain_codec=codec)
        assert len(up) == frames.uplink_bytes(3, 2, 64, 11, codec)
        parsed = frames.parse_uplink(up)
        assert parsed["codec"] == codec and len(parsed["rows"]) == 3
    down = wf.serialize_update(upd)
    assert len(down) == frames.downlink_bytes(3, 2, 64, 11)
    d = frames.parse_downlink(down)
    assert np.array_equal(d["ct"].view(np.int32), ct.data.numpy())
    assert math.isclose(d["scale"], ct.scale)
