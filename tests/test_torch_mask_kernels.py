"""The selection mask's split and merge kernels (`kernels/mask.py`,
`csrc/mask.cu`) and the per-partition layout they read.

CPU cases: the layout's tile counts are the mask's prefix sums and its
words pack the mask; split and merge through the wrappers equal the
boolean-index path and the JAX package's `split_by_mask` / `merge_by_mask`
bit for bit; and `csrc/mask.cu` compiled with g++ (a warp's lanes in turn,
through the kernels' own step functions) equals the plain version, over
all-encrypted, none-encrypted and random masks, an encrypted count that
fills whole slot blocks, and a length off the tile and the word.

The `cuda` cases run the kernels on the card against the plain version:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mask_kernels.py

This file imports JAX only inside the CPU cases that compare with it, so
it runs where only PyTorch is installed.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels import build, mask, ops

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = pathlib.Path(build.__file__).parent / "csrc"
SLOTS = 128
HUBERT_P = 945_808_640   # hubert-xlarge's parameters: byte offsets pass 2**31


MASKS = ("all", "none", "random_p0.1", "n_enc_whole_slots", "ragged")


def _mask_case(name):
    """(bool[P] mask, float32[P] vector) for a named case."""
    rng = np.random.RandomState(MASKS.index(name))
    if name == "all":
        m = np.ones(3000, bool)
    elif name == "none":
        m = np.zeros(3000, bool)
    elif name == "random_p0.1":
        m = rng.rand(10_000) < 0.1
    elif name == "n_enc_whole_slots":
        m = np.zeros(5000, bool)
        m[rng.choice(5000, 3 * SLOTS, replace=False)] = True
    elif name == "ragged":
        # two whole tiles and 37 elements: the last word holds 5 of them
        m = rng.rand(2 * mask.TILE + 37) < 0.3
    else:
        raise ValueError(name)
    return m, rng.randn(m.size).astype(np.float32)


def _boolean_index(vec, m, slots):
    """The split and merge as boolean indexing, the partition's own path
    before the kernels."""
    n_enc = int(m.sum())
    n_chunks = max(1, -(-n_enc // slots))
    enc = torch.zeros(n_chunks * slots, dtype=torch.float32)
    enc[:n_enc] = vec[m]
    return enc.reshape(n_chunks, slots), vec[~m]


# ---------------------------------------------------------------------------
# CPU: the layout, the wrappers, the kernels' steps under a host compiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MASKS)
def test_layout_tile_counts_match_prefix_sums(name):
    m, _ = _mask_case(name)
    lay = packing.make_partition(torch.from_numpy(m), SLOTS).layout("cpu")
    n_tiles = max(1, -(-m.size // mask.TILE))
    prefix = np.concatenate([[0], np.cumsum(m)])
    want = prefix[np.minimum(np.arange(n_tiles) * mask.TILE, m.size)]
    assert lay.tile_enc.dtype == torch.int64
    np.testing.assert_array_equal(lay.tile_enc.numpy(), want)
    assert lay.words.dtype == torch.int32
    assert lay.words.numel() == n_tiles * mask.TILE // 32
    bits = np.unpackbits(lay.words.numpy().view(np.uint8),
                         bitorder="little").astype(bool)
    np.testing.assert_array_equal(bits[:m.size], m)
    assert not bits[m.size:].any()


@pytest.mark.parametrize("name", MASKS)
def test_split_and_merge_match_boolean_index_and_jax(name):
    import jax.numpy as jnp

    from repro.core import packing as jpacking

    m, v = _mask_case(name)
    vec = torch.from_numpy(v)
    part = packing.make_partition(torch.from_numpy(m), SLOTS)
    ops.reset_launch_counts()
    enc, plain = packing.split_by_mask(vec, part)
    want_enc, want_plain = _boolean_index(vec, torch.from_numpy(m), SLOTS)
    jpart = jpacking.make_partition(m, SLOTS)
    jenc, jplain = jpacking.split_by_mask(jnp.asarray(v), jpart)
    for got, want in ((enc, want_enc), (plain, want_plain)):
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
    np.testing.assert_array_equal(enc.numpy(), np.asarray(jenc))
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jplain))
    out = packing.merge_by_mask(enc, plain, part)
    np.testing.assert_array_equal(out.numpy(), v)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jpacking.merge_by_mask(jenc, jplain, jpart)))
    # a CPU tensor takes the plain version: nothing launches
    assert ops.launch_counts()["mask_split"] == 0
    assert ops.launch_counts()["mask_merge"] == 0


@pytest.fixture(scope="module")
def mask_host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    so = tmp_path_factory.mktemp("mask") / "libmask_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-x", "c++",
                    "-o", str(so), str(CSRC / "mask.cu")], check=True,
                   capture_output=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.mask_split_host.argtypes = (p, p, p, ll, ll, ll, p, p)
    lib.mask_merge_host.argtypes = (p, p, ll, p, p, p, ll)
    lib.mask_split_host.restype = lib.mask_merge_host.restype = None
    return lib


@pytest.mark.parametrize("name", MASKS)
def test_kernel_steps_compiled_for_the_host_match_plain(mask_host_lib, name):
    """Outputs start as NaN, so every value, the pad of enc too, is the
    kernel's.  The merge reads enc at element stride 2, as it reads the
    real part of the decode's complex output."""
    m, v = _mask_case(name)
    vec = torch.from_numpy(v)
    part = packing.make_partition(torch.from_numpy(m), SLOTS)
    lay = part.layout("cpu")
    want_enc, want_plain = mask.split_plain(vec, part)
    enc = torch.full((part.n_enc_padded,), float("nan"))
    plain = torch.full((part.n_plain,), float("nan"))
    mask_host_lib.mask_split_host(
        vec.data_ptr(), lay.words.data_ptr(), lay.tile_enc.data_ptr(),
        part.n_total, part.n_enc, part.n_enc_padded, enc.data_ptr(),
        plain.data_ptr())
    assert torch.equal(enc.reshape(part.n_chunks, SLOTS), want_enc)
    assert torch.equal(plain, want_plain)
    strided = torch.stack([enc, torch.full_like(enc, float("nan"))], -1)
    out = torch.full((part.n_total,), float("nan"))
    mask_host_lib.mask_merge_host(
        out.data_ptr(), strided.data_ptr(), 2, plain.data_ptr(),
        lay.words.data_ptr(), lay.tile_enc.data_ptr(), part.n_total)
    assert torch.equal(out, vec)
    assert torch.equal(out, mask.merge_plain(strided[:, 0], plain, part))


def test_layout_is_built_once_per_device_and_kept():
    m, _ = _mask_case("random_p0.1")
    part = packing.make_partition(torch.from_numpy(m), SLOTS)
    lay = part.layout("cpu")
    assert part.layout(torch.device("cpu")) is lay
    assert part.n_enc == int(m.sum())
    assert "_layouts" not in repr(part)


@pytest.mark.parametrize("op", ["mask_split", "mask_merge"])
def test_wrappers_refuse_tensors_neither_cpu_nor_cuda(op):
    """A non-CPU tensor goes to the kernel or raises; it never runs the
    plain version.  (`meta` stands in for a device without a kernel.)"""
    part = packing.make_partition(torch.ones(256, dtype=torch.bool), SLOTS)
    x = torch.empty(256, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        if op == "mask_split":
            mask.mask_split(x, part)
        else:
            mask.mask_merge(x.reshape(2, SLOTS), x[:0], part)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _on_card(name, dev):
    m, v = _mask_case(name)
    return (packing.make_partition(torch.from_numpy(m).to(dev), SLOTS),
            torch.from_numpy(v).to(dev))


def _launch_split(vec, part, enc, plain):
    lay = part.layout(vec.device)
    build.launch("mask", "mask_split_launch", vec, lay.words, lay.tile_enc,
                 part.n_total, part.n_enc, part.n_enc_padded, enc, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("name", MASKS)
def test_kernels_match_plain_on_the_card(cuda, name):
    part, vec = _on_card(name, cuda)
    ops.reset_launch_counts()
    enc, plain = mask.mask_split(vec, part)
    want_enc, want_plain = mask.split_plain(vec, part)
    assert torch.equal(enc, want_enc) and torch.equal(plain, want_plain)
    assert torch.equal(mask.mask_merge(enc, plain, part), vec)
    # the decode's real part: a stride-2 view, read in place
    strided = torch.stack([enc, torch.full_like(enc, float("nan"))], -1)
    got = mask.mask_merge(strided[..., 0], plain, part)
    assert torch.equal(got, mask.merge_plain(strided[..., 0], plain, part))
    torch.cuda.synchronize()
    assert ops.launch_counts()["mask_split"] == 1
    assert ops.launch_counts()["mask_merge"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", MASKS)
def test_split_writes_every_output_over_nan_garbage(cuda, name):
    part, vec = _on_card(name, cuda)
    enc = torch.full((part.n_enc_padded,), float("nan"), device=cuda)
    plain = torch.full((part.n_plain,), float("nan"), device=cuda)
    _launch_split(vec, part, enc, plain)
    want_enc, want_plain = mask.split_plain(vec, part)
    torch.cuda.synchronize()
    assert torch.equal(enc.reshape(want_enc.shape), want_enc)
    assert torch.equal(plain, want_plain)


@pytest.mark.cuda
def test_kernels_match_plain_at_hubert_size(cuda):
    """P = 945,808,640 at p = 0.1: the vector's byte offsets pass 2**31."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    m = torch.rand(HUBERT_P, generator=gen, device=cuda) < 0.1
    part = packing.make_partition(m, 4096)
    vec = torch.randn(HUBERT_P, generator=gen, device=cuda)
    enc, plain = mask.mask_split(vec, part)
    want_enc, want_plain = mask.split_plain(vec, part)
    assert torch.equal(enc, want_enc) and torch.equal(plain, want_plain)
    del want_enc, want_plain
    out = mask.mask_merge(enc, plain, part)
    assert torch.equal(out, vec)
    assert torch.equal(out, mask.merge_plain(enc, plain, part))


@pytest.mark.cuda
def test_launch_counts_move_by_one_per_call(cuda):
    part, vec = _on_card("random_p0.1", cuda)
    ops.reset_launch_counts()
    for i in range(1, 4):
        enc, plain = packing.split_by_mask(vec, part)
        assert ops.launch_counts()["mask_split"] == i
        packing.merge_by_mask(enc, plain, part)
        assert ops.launch_counts()["mask_merge"] == i


@pytest.mark.cuda
def test_split_and_merge_never_sync_once_the_layout_is_built(cuda):
    part, vec = _on_card("ragged", cuda)
    part.layout(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        enc, plain = packing.split_by_mask(vec, part)
        out = packing.merge_by_mask(enc, plain, part)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, vec)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    part, vec = _on_card("random_p0.1", cuda)
    enc, plain = mask.mask_split(vec, part)
    with pytest.raises(TypeError):
        mask.mask_split(vec.double(), part)
    with pytest.raises(ValueError, match="shape"):
        mask.mask_split(vec[1:], part)
    with pytest.raises(ValueError, match="aligned"):
        mask.mask_split(torch.cat([vec, vec[:1]])[1:], part)
    with pytest.raises(TypeError):
        mask.mask_merge(enc, plain.half(), part)
    with pytest.raises(ValueError, match="fewer"):
        mask.mask_merge(enc.reshape(-1)[: part.n_enc - 1], plain, part)
