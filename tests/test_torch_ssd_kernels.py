"""The Mamba-2 SSD's kernels (`kernels/ssd.py`, `csrc/ssd.cu`) and the
dispatch of `models/mamba2.py` `ssd_chunked`.

CPU cases: CPU tensors take the plain version and launch nothing, under
torch.func too; the shape check takes each configuration's (chunk,
head_dim, state) and refuses others; the build lists the source; and
`csrc/ssd.cu` compiled with g++ (each block's 256 threads as host threads,
the same launch sequence) gives y, h_final and the five gradients of
autograd through `ssd_chunked_plain`.  Through that host build the
autograd Functions of `kernels/ssd.py` run on CPU tensors (`_cuda_call`
and the device check patched): under torch.func's grad and a jvp of a
grad they match the plain version, refuse what they have no
rule for, and give a mamba2 smoke model's sensitivity map with the
launches it counts.

The `cuda` cases run the kernels on the card against autograd through the
plain version, and one mamba2-370m training step through both paths:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssd_kernels.py

Tolerance: the kernels sum in another order than the plain version, so
each output is held to 4 times the plain version's own distance (relative
L2) from a float64 run of the plain version on the same inputs: a kernel
that is as exact as the plain float32 path passes with room, one that
drops a term or mixes two does not.  `da` is a sum over every step of
terms of both signs, so the plain version's distance there can fall far
below the rounding its terms carry on one draw (its ratio to the kernels'
ranged 0.4 to 17 over seeds): its own distance is the larger of its
distance in da and the summed distance of its per-step terms (the
gradient of a broadcast to every step).  This file imports no JAX.
"""
import ctypes
import importlib
import pathlib
import shutil
import subprocess

import pytest
import torch

from repro_torch.kernels import build, ops, ssd
from repro_torch.models import mamba2

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = pathlib.Path(build.__file__).parent / "csrc"
TOL_FACTOR = 4.0

# (batch, seq, heads, head_dim, state, chunk): the mamba2-370m FULL widths
# at 2 rows, zamba2-7b's at one row of 1,024 (112 heads), both SMOKEs', and
# a chunk of 65 steps (a prefill's; rows of C B^T off the 16-byte grid)
CARD_SHAPES = {
    "mamba2_370m": (2, 2048, 32, 64, 128, 256),
    "zamba2_7b": (1, 1024, 112, 64, 64, 256),
    "smoke": (2, 64, 8, 16, 16, 8),
    "chunk_of_65": (1, 130, 4, 64, 64, 65),
}
# host shapes: small enough for host threads, every width and a ragged chunk
HOST_SHAPES = {
    "smoke": (2, 16, 3, 16, 16, 8),
    "one_chunk_of_37": (1, 37, 2, 16, 16, 256),
    "chunk_65": (1, 130, 2, 64, 64, 65),
    "mamba2_widths": (1, 512, 2, 64, 128, 256),
}


def _inputs(shape, dtype, device, with_h0, with_dhf, seed=0):
    bsz, s, nh, hd, st, _ = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(bsz, s, nh, hd, generator=g)
    dt = torch.rand(bsz, s, nh, generator=g) * 0.3 + 0.01
    a = -(torch.rand(nh, generator=g) * 3 + 0.1)
    b = torch.randn(bsz, s, st, generator=g)
    c = torch.randn(bsz, s, st, generator=g)
    h0 = torch.randn(bsz, nh, hd, st, generator=g) if with_h0 else None
    dy = torch.randn(bsz, s, nh, hd, generator=g)
    dhf = torch.randn(bsz, nh, hd, st, generator=g) if with_dhf else None
    mv = lambda t, dt_=dtype: None if t is None else t.to(device, dt_)
    return (mv(x), mv(dt, torch.float32), mv(a, torch.float32), mv(b),
            mv(c), mv(h0, torch.float32), mv(dy), mv(dhf))


def _plain_grads(x, dt, a, b, c, h0, dy, dhf, chunk, dtype=None):
    """y, h_final and the gradients of <y, dy> + <h_final, dhf> by autograd
    through the plain version, its inputs cast to dtype (None: as given)."""
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    ins = [cast(t).requires_grad_() for t in (x, dt, a, b, c)]
    h0r = None if h0 is None else cast(h0).requires_grad_()
    y, hf = mamba2.ssd_chunked_plain(*ins, chunk, h0r)
    loss = (y.double() * dy.double()).sum()
    if dhf is not None:
        loss = loss + (hf.double() * dhf.double()).sum()
    wrt = ins + ([h0r] if h0r is not None else [])
    grads = torch.autograd.grad(loss, wrt)
    return dict(zip(("y", "h_final", "dx", "ddt", "da", "db", "dc", "dh0"),
                    (y.detach(), hf.detach(), *grads)))


def _da_terms(x, dt, a, b, c, h0, dy, dhf, chunk, dtype=None):
    """The per-step terms of da [B, S, H] (float64): the gradient of a
    broadcast to every step, through the plain version."""
    bsz, s, nh, _ = x.shape
    q = min(chunk, s)
    cast = (lambda t: t) if dtype is None else (lambda t: t.to(dtype))
    ab = cast(a)[None, None, None, :].expand(bsz, s // q, q, nh)
    ab = ab.clone().requires_grad_()
    y, hf = mamba2.ssd_chunked_plain(cast(x), cast(dt), ab, cast(b), cast(c),
                                     chunk, None if h0 is None else cast(h0))
    loss = (y.double() * dy.double()).sum()
    if dhf is not None:
        loss = loss + (hf.double() * dhf.double()).sum()
    (g,) = torch.autograd.grad(loss, ab)
    return g.reshape(bsz, s, nh).double()


def _rel(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _check_against_plain(got, x, dt, a, b, c, h0, dy, dhf, chunk):
    want64 = _plain_grads(x, dt, a, b, c, h0, dy, dhf, chunk, torch.float64)
    plain = _plain_grads(x, dt, a, b, c, h0, dy, dhf, chunk)
    assert set(got) == set(want64)
    for name, want in want64.items():
        assert got[name].dtype == plain[name].dtype, name
        assert got[name].shape == want.shape, name
        own = _rel(plain[name], want)
        if name == "da":
            terms = _da_terms(x, dt, a, b, c, h0, dy, dhf, chunk)
            terms64 = _da_terms(x, dt, a, b, c, h0, dy, dhf, chunk,
                                torch.float64)
            own = max(own, float((terms - terms64).abs().sum((0, 1)).norm()
                                 / want.norm()))
        err = _rel(got[name], want)
        assert err <= TOL_FACTOR * own, (name, err, own)


# ---------------------------------------------------------------------------
# CPU: the dispatch, the shape check, the build, the host-compiled kernels
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version():
    x, dt, a, b, c, h0, dy, _ = _inputs(HOST_SHAPES["smoke"], torch.float32,
                                        "cpu", True, False)
    ops.reset_launch_counts()
    ins = [t.requires_grad_() for t in (x, dt, a, b, c)]
    y, hf = mamba2.ssd_chunked(*ins, 8, h0)
    gy = torch.autograd.grad((y * dy).sum(), ins)
    ins2 = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
    y2, hf2 = mamba2.ssd_chunked_plain(*ins2, 8, h0)
    gy2 = torch.autograd.grad((y2 * dy).sum(), ins2)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    assert all(torch.equal(g, g2) for g, g2 in zip(gy, gy2))
    counts = ops.launch_counts()
    assert counts["ssd_fwd"] == 0 and counts["ssd_bwd"] == 0


def test_torch_func_grad_runs_the_plain_version():
    """CPU tensors under torch.func.grad: the plain version's gradient,
    nothing launched."""
    x, dt, a, b, c, _, dy, _ = _inputs(HOST_SHAPES["smoke"], torch.float32,
                                       "cpu", False, False)

    def loss(xx):
        y, _ = mamba2.ssd_chunked(xx, dt, a, b, c, 8)
        return (y * dy).sum()

    ops.reset_launch_counts()
    g = torch.func.grad(loss)(x)
    xr = x.detach().requires_grad_()
    y, _ = mamba2.ssd_chunked_plain(xr, dt, a, b, c, 8)
    (gr,) = torch.autograd.grad((y * dy).sum(), xr)
    assert torch.equal(g, gr)
    counts = ops.launch_counts()
    assert counts["ssd_fwd"] == 0 and counts["ssd_bwd"] == 0


@pytest.mark.parametrize("arch", ["mamba2_370m", "zamba2_7b"])
@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_shape_check_accepts_each_config(arch, size):
    cfg = getattr(importlib.import_module(f"repro_torch.configs.{arch}"),
                  size)
    assert (cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state) in {
        (256, 64, 128), (256, 64, 64), (8, 16, 16)}
    ssd.check_shape(cfg.ssm_chunk, cfg.ssm_head_dim, cfg.ssm_state)


@pytest.mark.parametrize("q, hd, st", [(256, 32, 128), (256, 64, 32),
                                       (512, 64, 128), (0, 16, 16),
                                       (256, 128, 64)])
def test_shape_check_refuses_other_shapes(q, hd, st):
    with pytest.raises(ValueError):
        ssd.check_shape(q, hd, st)


def test_build_lists_the_ssd_source():
    assert "ssd" in build.SOURCES and (CSRC / "ssd.cu").exists()
    sig = build.SIGNATURES["ssd"]
    # 7 ints, then the pointers of ssd.fwd's and ssd.bwd's calls, the stream
    assert len(sig["ssd_fwd_launch"]) == 7 + 11 + 1
    assert len(sig["ssd_bwd_launch"]) == 7 + 23 + 1
    assert set(ops.KERNELS) >= {"ssd_fwd", "ssd_bwd"}
    assert ops.KERNELS["ssd_fwd"] is ssd.ssd_fwd


def test_cost_counts_the_causal_work():
    """The roofline's operations at the fl cell's shape, by hand: per
    (batch, chunk, head) the state's and the inter output's Q P N products
    and the intra output's Q (Q + 1) / 2 P, per (batch, chunk) C B^T's
    Q (Q + 1) / 2 N; the backward four Q P N and two triangles a head and
    three triangles of N a chunk."""
    bsz, s, nh, hd, st, q = 16, 2048, 32, 64, 128, 256
    heads, chunks, tri = bsz * (s // q) * nh, bsz * (s // q), q * (q + 1) // 2
    c = ssd.cost(bsz, s, nh, hd, st, q)
    assert c["fwd_flops"] == 2 * (heads * (2 * q * hd * st + tri * hd)
                                  + chunks * tri * st) == 52_684_652_544
    assert c["bwd_flops"] == 2 * (heads * (4 * q * hd * st + 2 * tri * hd)
                                  + chunks * 3 * tri * st)
    # x, B, C and y in bfloat16, dt and the states in float32
    assert c["fwd_bytes"] == (2 * bsz * s * nh * hd * 2 + 2 * bsz * s * st * 2
                              + bsz * s * nh * 4
                              + bsz * (s // q) * nh * hd * st * 4)


@pytest.fixture(scope="module")
def ssd_host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not available")
    so = tmp_path_factory.mktemp("ssd") / "libssd_host.so"
    subprocess.run([gxx, "-O2", "-std=c++20", "-pthread", "-shared", "-fPIC",
                    "-x", "c++", "-o", str(so), str(CSRC / "ssd.cu")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.ssd_fwd_host.argtypes = (i,) * 7 + (p,) * 11
    lib.ssd_bwd_host.argtypes = (i,) * 7 + (p,) * 23
    lib.ssd_fwd_host.restype = lib.ssd_bwd_host.restype = ctypes.c_int
    return lib


def _host_call(lib):
    def call(fn, *args):
        err = getattr(lib, fn + "_host")(
            *[t.data_ptr() if isinstance(t, torch.Tensor) else t
              for t in args])
        assert err == 0, (fn, err)
    return call


@pytest.fixture
def host_kernels(ssd_host_lib, monkeypatch):
    """The wrappers and Functions of kernels/ssd.py on CPU tensors, through
    the host build."""
    monkeypatch.setattr(ssd, "_cuda_call", _host_call(ssd_host_lib))
    monkeypatch.setattr(build, "require_cuda", lambda name, t: None)


def _run_kernels(x, dt, a, b, c, h0, dy, dhf, chunk):
    """The wrappers' forward and backward, as the Functions call them."""
    q = min(chunk, x.shape[1])
    y, hf, hbuf, cum = ssd.fwd(x, dt, a, b, c, q, h0)
    dx, ddt, da, db, dc, dh0 = ssd.bwd(x, dt, a, b, c, hbuf, cum, q, dy, dhf,
                                       h0 is not None)
    got = dict(y=y, h_final=hf, dx=dx, ddt=ddt, da=da, db=db, dc=dc)
    if h0 is not None:
        got["dh0"] = dh0
    return got


@pytest.mark.parametrize("name", sorted(HOST_SHAPES))
@pytest.mark.parametrize("with_h0, with_dhf", [(False, False), (True, True)])
def test_kernels_compiled_for_the_host_match_plain(host_kernels, name,
                                                    with_h0, with_dhf):
    shape = HOST_SHAPES[name]
    args = _inputs(shape, torch.float32, "cpu", with_h0, with_dhf)
    got = _run_kernels(*args, shape[-1])
    _check_against_plain(got, *args, shape[-1])


def test_kernels_compiled_for_the_host_read_bfloat16(host_kernels):
    """x, B and C in bfloat16, widened in the kernels: against the plain
    version on the same bfloat16 inputs (its products in float32 too)."""
    shape = (1, 24, 5, 16, 16, 8)
    args = _inputs(shape, torch.bfloat16, "cpu", False, True)
    got = _run_kernels(*args, 8)
    _check_against_plain(got, *args, 8)
    assert got["y"].dtype == got["dx"].dtype == torch.bfloat16


# torch.func through the Functions: the function of each transform on the
# plain version and on the kernels, and the launches the kernels' run counts
# (a loss of y and h_final with a label `lab` that enters only through dy,
# as the sensitivity maps' labels do)


def _transform(name, fn, x, dt, a, b, c, h0, lab, q):
    def loss(xx, bb, cc, hh, yl):
        y, hf = fn(xx, dt, a, bb, cc, q, hh)
        return (y.to(yl) * yl).sum() + (hf.to(yl) ** 2).sum()

    if name == "grad":
        return torch.func.grad(loss, argnums=(0, 1, 2, 3))(x, b, c, h0, lab)
    def grads(yl):
        return torch.func.grad(loss, argnums=(0, 1, 2, 3))(x, b, c, h0, yl)

    v = torch.randn(lab.shape, generator=torch.Generator().manual_seed(7))
    return torch.func.jvp(grads, (lab,), (v.to(lab),))[1]


# transform -> (ssd_fwd, ssd_bwd) launches: grad one each way; a jvp of a
# grad one more backward, for dy's tangent
FUNC_TRANSFORMS = {"grad": (1, 1), "jvp_of_grad": (1, 2)}


def _check_transform(name, shape, device):
    x, dt, a, b, c, h0, lab, _ = _inputs(shape, torch.float32, device, True,
                                         False)
    q = shape[-1]
    ops.reset_launch_counts()
    got = _transform(name, ssd.ssd, x, dt, a, b, c, h0, lab, q)
    counts = ops.launch_counts()
    assert (counts["ssd_fwd"], counts["ssd_bwd"]) == FUNC_TRANSFORMS[name]
    want = _transform(name, mamba2.ssd_chunked_plain, x, dt, a, b, c, h0,
                      lab, q)
    d64 = lambda t: t.double()
    want64 = _transform(name, mamba2.ssd_chunked_plain, *map(d64, (
        x, dt, a, b, c, h0, lab)), q)
    assert len(got) == len(want) == len(want64)
    for k, (g, w, w64) in enumerate(zip(got, want, want64)):
        assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
        own = _rel(w, w64)
        assert _rel(g, w64) <= TOL_FACTOR * max(own, 1e-7), (name, k)


@pytest.mark.parametrize("name", sorted(FUNC_TRANSFORMS))
def test_torch_func_through_the_kernels_matches_plain(host_kernels, name):
    _check_transform(name, HOST_SHAPES["smoke"], "cpu")


def test_torch_func_refuses_what_the_kernels_have_no_rule_for(host_kernels):
    """A tangent through the forward, vmap and a second reverse derivative
    raise; a tangent that is zero is no tangent and passes."""
    x, dt, a, b, c, _, dy, _ = _inputs(HOST_SHAPES["smoke"], torch.float32,
                                       "cpu", False, False)
    f_x = lambda xx: ssd.ssd(xx, dt, a, b, c, 8)[0]
    with pytest.raises(NotImplementedError):
        torch.func.jvp(f_x, (x,), (torch.ones_like(x),))
    _, ty = torch.func.jvp(f_x, (x,), (torch.zeros_like(x),))
    assert not ty.any()
    with pytest.raises(RuntimeError, match="vmap"):
        torch.func.vmap(lambda xx: ssd.ssd(xx, dt, a, b, c, 8)[0])(x[None])
    grad_x = torch.func.grad(lambda xx: (ssd.ssd(xx, dt, a, b, c, 8)[0]
                                         * dy).sum())
    with pytest.raises(NotImplementedError):
        torch.func.grad(lambda xx: grad_x(xx).sum())(x)


def test_sensitivity_map_through_the_kernels(host_kernels, monkeypatch):
    """The mamba2 smoke model's sensitivity map (the Hutchinson jvp of a
    grad, `FLClient.sensitivity_map_from_probes`) with the SSD on the
    kernels: the plain version's map, one forward and two backward
    launches a layer and probe."""
    from repro_torch import configs, models
    from repro_torch.core import sensitivity
    from repro_torch.data.synthetic import make_client_streams
    from repro_torch.fl import ClientConfig, FLClient

    cfg = configs.get_config("mamba2-370m", smoke=True)
    model = models.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    stream = make_client_streams(1, cfg.vocab, seq_len=16, batch_size=2,
                                 seed=3)[0]
    batch = {k: torch.as_tensor(v) for k, v in stream.next_batch().items()}
    client = FLClient(0, model, stream, ClientConfig(sensitivity_probes=2))
    y = torch.nn.functional.one_hot(batch["labels"].long(), cfg.vocab).float()
    probes = sensitivity.sample_probes(y, torch.Generator().manual_seed(1), 2)
    want = client.sensitivity_map_from_probes(params, batch, probes)
    monkeypatch.setattr(mamba2, "ssd_chunked", lambda *a, **k: ssd.ssd(
        *a, **k))
    ops.reset_launch_counts()
    got = client.sensitivity_map_from_probes(params, batch, probes)
    counts = ops.launch_counts()
    assert (counts["ssd_fwd"], counts["ssd_bwd"]) == (
        cfg.n_layers * 2, 2 * cfg.n_layers * 2)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-5, _rel(got, want)


# ---------------------------------------------------------------------------
# cuda: the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("with_dhf", [False, True])
def test_kernels_match_plain_on_the_card(cuda, name, with_h0, with_dhf):
    shape = CARD_SHAPES[name]
    args = _inputs(shape, torch.float32, cuda, with_h0, with_dhf)
    got = _run_kernels(*args, shape[-1])
    torch.cuda.synchronize()
    _check_against_plain(got, *args, shape[-1])


@pytest.mark.cuda
def test_function_counts_one_launch_each_way(cuda):
    x, dt, a, b, c, h0, dy, _ = _inputs(CARD_SHAPES["smoke"], torch.bfloat16,
                                        cuda, True, False)
    ops.reset_launch_counts()
    ins = [t.requires_grad_() for t in (x, dt, a, b, c, h0)]
    y, hf = mamba2.ssd_chunked(*ins[:5], 8, ins[5])
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), ins)
    assert [g.dtype for g in grads] == [t.dtype for t in ins]
    counts = ops.launch_counts()
    assert (counts["ssd_fwd"], counts["ssd_bwd"]) == (1, 1)
    assert y.dtype == hf.dtype == torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUNC_TRANSFORMS))
def test_torch_func_on_the_card_takes_the_kernels(cuda, name):
    """torch.func on CUDA tensors runs the kernels (the launches say so)
    and matches the plain version there."""
    _check_transform(name, (1,) + CARD_SHAPES["mamba2_370m"][1:], cuda)


@pytest.mark.cuda
def test_kernels_refuse_a_shape_they_do_not_take(cuda):
    x = torch.zeros(1, 64, 2, 32, device=cuda)
    b = torch.zeros(1, 64, 16, device=cuda)
    dt = torch.zeros(1, 64, 2, device=cuda)
    with pytest.raises(ValueError):
        mamba2.ssd_chunked(x, dt, dt[0, 0], b, b, 8)


@pytest.mark.cuda
def test_a_training_step_through_both_paths(cuda, monkeypatch):
    """mamba2-370m FULL (48 layers, remat), 2 rows of 2,048 tokens: the loss
    and every leaf's gradient norm of the kernels' path against the plain
    path's.  The model computes in bfloat16, so the two paths' y round to
    bfloat16 at a few other places and the step's numbers differ by that
    rounding carried through 48 layers: the loss within 1e-3, a norm within
    1e-2 (relative)."""
    from repro_torch import models

    cfg = importlib.import_module("repro_torch.configs.mamba2_370m").FULL
    assert cfg.remat and cfg.n_layers == 48
    model = models.build_model(cfg, device=cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    g = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, 50_277, (2, 2049), generator=g, device=cuda,
                           dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    step = models.value_and_grad(model.loss_fn)
    ops.reset_launch_counts()
    loss, grads = step(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["ssd_fwd"], counts["ssd_bwd"]) == (2 * 48, 48)
    monkeypatch.setattr(mamba2, "ssd_chunked", mamba2.ssd_chunked_plain)
    ops.reset_launch_counts()
    loss_p, grads_p = step(params, batch)
    assert ops.launch_counts()["ssd_fwd"] == 0
    assert abs(float(loss) - float(loss_p)) <= 1e-3 * abs(float(loss_p))
    from repro_torch.core import packing

    for gk, gp in zip(packing.tree_leaves(grads), packing.tree_leaves(
            grads_p)):
        nk, np_ = float(gk.float().norm()), float(gp.float().norm())
        assert abs(nk - np_) <= 1e-2 * np_ + 1e-12, (nk, np_)
