"""The backend contract of the device path: one capability check, the
compile-cache helper, device failures that raise instead of falling
back to the host, explicit matmul precision on the pixel path, and the
jnp filter chain against the float64 host oracle."""

import os
import types

import jax
import jax.extend
import numpy as np
import pytest

from jxl_coder import api, backend
from jxl_coder.vardct import device_full as TF
from jxl_coder.vardct import enc_device as ENCDEV


def _img(h=64, w=96, seed=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([120 + 70 * np.sin(yy / 9.0), (xx * 2) % 230,
                    90 + 60 * np.cos((xx + yy) / 13.0)], -1)
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(
        np.uint8)


# ---- capability check --------------------------------------------------

@pytest.mark.parametrize("platform,expected", [("gpu", True),
                                               ("cpu", False)])
def test_accelerator_present_reads_default_device(monkeypatch, platform,
                                                  expected):
    fake = types.SimpleNamespace(platform=platform)
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    assert backend.accelerator_present() is expected


def test_device_enabled_leaves_jax_config_alone(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: calls.append(a))
    for env in ("1", "0", ""):
        monkeypatch.setenv("JXL_DEVICE", env)
        TF.device_enabled()
    assert calls == []


# ---- environment knobs ---------------------------------------------------

@pytest.mark.parametrize("name,hint", [
    ("JXL_X_DEVICE", "set JXL_DEVICE"),
    ("JXL_X_ENC_DEVICE", "set JXL_ENC_DEVICE"),
    ("JXL_X_ENTROPY", "set JXL_ENTROPY"),
    ("JXL_X_MODULAR_DEVICE", "set JXL_MODULAR_DEVICE"),
    ("JXL_X_XLA_CACHE", "use JAX_COMPILATION_CACHE_DIR"),
    ("JXL_X_DEVICE_STRICT", "device failures always raise"),
])
def test_old_knob_names_are_refused(monkeypatch, name, hint):
    monkeypatch.setenv(name, "1")
    with pytest.raises(RuntimeError, match=hint):
        TF.device_enabled()


def test_knob_reads_current_names(monkeypatch):
    monkeypatch.setenv("JXL_DEVICE", "0")
    monkeypatch.setenv("JXL_SOMETHING", "1")      # not a knob form
    assert backend.knob("JXL_DEVICE") == "0"
    assert backend.knob("JXL_ENC_DEVICE", "1") == "1"
    assert TF.device_enabled() is False


# ---- compile cache -----------------------------------------------------

@pytest.fixture
def no_cache_dir(monkeypatch):
    """JAX with no compile-cache directory configured; jax.config.update
    calls are recorded, and the setting is restored afterwards."""
    real = jax.config.update
    before = jax.config.jax_compilation_cache_dir
    real("jax_compilation_cache_dir", None)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a, **k: (calls.append(a), real(*a, **k)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    yield calls
    real("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(no_cache_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.use_compile_cache() == str(tmp_path)
    assert no_cache_dir == []


def test_compile_cache_keeps_callers_dir(no_cache_dir, tmp_path):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    no_cache_dir.clear()
    assert backend.use_compile_cache() == str(tmp_path)
    assert no_cache_dir == []


def test_compile_cache_defaults_into_checkout(no_cache_dir):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = backend.use_compile_cache()
    assert d == os.path.join(repo, ".jax_cache") and os.path.isdir(d)
    assert no_cache_dir == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_off_in_read_only_checkout(no_cache_dir,
                                                 monkeypatch):
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    assert backend.use_compile_cache() is None
    assert no_cache_dir == []


@pytest.mark.parametrize("build", ["frame", "front", "costs"])
def test_program_build_turns_on_compile_cache(monkeypatch, frame_exec,
                                              build):
    calls = []
    monkeypatch.setattr(backend, "use_compile_cache",
                        lambda: calls.append(1))
    if build == "frame":
        TF._compiled.__wrapped__(**frame_exec[0])
    elif build == "front":
        ENCDEV._front.__wrapped__(64, 64, 4)
    else:
        from jxl_coder.vardct.enc_real import _EFFORT_CANDS
        ENCDEV._costs.__wrapped__(8, 8, tuple(_EFFORT_CANDS["full"]), 0.5)
    assert calls == [1]


# ---- device failures raise --------------------------------------------

class DeviceDown(RuntimeError):
    pass


def _boom(*a, **k):
    raise DeviceDown("device dispatch failed")


def test_decode_device_failure_raises(monkeypatch):
    data = api.encode(_img(), lossless=False, quality=90)
    monkeypatch.setenv("JXL_DEVICE", "1")
    monkeypatch.setattr(TF, "reconstruct_frame_device", _boom)
    with pytest.raises(DeviceDown):
        api.decode(data)


def test_decode_batch_device_failure_raises(monkeypatch):
    datas = [api.encode(_img(seed=s), lossless=False, quality=90)
             for s in (1, 2)]
    monkeypatch.setenv("JXL_DEVICE", "1")
    monkeypatch.setattr(TF, "reconstruct_state_device", _boom)
    with pytest.raises(DeviceDown):
        api.decode_batch(datas)


def test_encode_device_failure_raises(monkeypatch):
    monkeypatch.setenv("JXL_DEVICE", "1")
    monkeypatch.setattr(ENCDEV, "run_front_dispatch", _boom)
    with pytest.raises(DeviceDown):
        api.encode(_img(), lossless=False, quality=90)


# ---- precision of every pixel-path dot_general -------------------------

def _dot_precisions(closed_jaxpr):
    """precision param of every dot_general, sub-jaxprs included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jax.extend.core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jax.extend.core.Jaxpr):
                        walk(sub)
    walk(closed_jaxpr.jaxpr)
    return out


def _assert_highest(closed_jaxpr):
    precs = _dot_precisions(closed_jaxpr)
    assert precs, "no dot_general traced"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p in (hi, (hi, hi)), p


@pytest.fixture(scope="module")
def frame_exec():
    import chip_smoke
    data = api.encode(_img(48, 64), lossless=False, quality=90)
    state = chip_smoke._parse_state(data)
    static, args, _ = TF.prepare_exec(state)
    return static, args


def _post_extras(h, w, n_up=2):
    from jxl_coder.ops.upsample import _kernels
    rng = np.random.default_rng(0)
    return {"mul": np.ones((3, h, w), np.float32),
            "add": np.zeros((3, h, w), np.float32),
            "rnd": rng.random((3, h, w), np.float32),
            "lut": np.full(8, 0.1, np.float32),
            "upk": np.asarray(_kernels(n_up, None), np.float32)}


_GM = tuple(np.eye(3, dtype=np.float32).ravel().tolist())
_LUMA = (0.2627, 0.678, 0.0593)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("post", [
    (),
    (("overlay", True), ("noise", True), ("ups", 2),
     ("out", ("gamma", 0.45))),
    (("down", 4), ("out", ("srgb",))),
    (("out", ("enc", 16, _GM, 4000.0, _LUMA)),),
    (("out", ("enc", 18, _GM, 1000.0, _LUMA)),),
])
def test_frame_program_matmuls_highest(frame_exec, bits, post):
    static, args = frame_exec
    st = dict(static, bits=bits, post=post)
    fn = TF._build_fn(**st)
    extra = (_post_extras(st["crop_h"], st["crop_w"]),) if post else ()
    _assert_highest(jax.make_jaxpr(fn)(*args, *extra))


def test_encoder_front_and_costs_matmuls_highest():
    from jxl_coder.vardct.enc_real import _EFFORT_CANDS, _SPECIAL_CANDS
    ph, pw = 64, 64
    ys, xs = ph // 8, pw // 8
    front = ENCDEV._front(ph, pw, 4)
    _assert_highest(jax.make_jaxpr(front)(
        np.zeros((ph, pw, 3), np.float32)))
    costs, _ = ENCDEV._costs(ys, xs, tuple(_EFFORT_CANDS["full"]), 0.5,
                             tuple(_SPECIAL_CANDS))
    z = np.zeros
    _assert_highest(jax.make_jaxpr(costs)(
        z((3, ph, pw), np.float32), z((3, ys, xs, 8, 8), np.float32),
        np.ones((ys, xs), np.int32), z((ys, xs), np.float32),
        z((ys, xs), np.float32), z((3, ys, xs), np.float32),
        np.float32(1.0), np.float32(1.0), np.ones((ys, xs), bool)))


def test_resize_and_colour_matmuls_highest(monkeypatch):
    from jxl_coder.ops import color as C
    from jxl_coder.ops import resize as R
    img = np.zeros((3, 16, 24), np.float32)
    _assert_highest(jax.make_jaxpr(
        lambda x: R.resize_plane_stack(x, 8, 12))(img))
    _assert_highest(jax.make_jaxpr(
        lambda x: C.apply_matrix(np.eye(3), x))(img))
    _assert_highest(jax.make_jaxpr(
        lambda x: C.rec2408_tone_map(x, 1000.0))(img))
    _assert_highest(jax.make_jaxpr(
        lambda x: C.transfer_tone_rec2408(x, 1000.0))(
            np.zeros((4, 5, 3), np.float32)))
    # hdr_to_sdr runs eagerly on host arrays: check its einsum call
    seen = []
    real = C.jnp.einsum
    monkeypatch.setattr(C.jnp, "einsum", lambda *a, **k: (
        seen.append(k.get("precision")), real(*a, **k))[1])
    from jxl_coder.bitstream.headers import ColourEncoding
    ce = ColourEncoding()
    ce.transfer_function = 16
    C.hdr_to_sdr(np.full((4, 5, 3), 30000, np.uint16), ce, 1000.0)
    assert seen and all(p == backend.PRECISION for p in seen), seen


# ---- the jnp filter chain against the float64 host oracle --------------

@pytest.mark.parametrize("W", [128, 3840])
@pytest.mark.parametrize("epf_iters", [1, 2, 3])
def test_filter_chain_matches_host(W, epf_iters):
    from jxl_coder.bitstream.frame_header import RestorationFilter
    from jxl_coder.vardct import dec_real
    rng = np.random.default_rng(W + epf_iters)
    H = 21                                   # not a multiple of 8
    planes = [rng.normal(0.0, s, (H, W)) for s in (0.02, 0.3, 0.1)]
    sigma = rng.uniform(0.0, 1.5, (-(-H // 8), -(-W // 8)))
    rf = RestorationFilter(gab=True, epf_iters=epf_iters)
    host = dec_real._apply_filters_chain(*[p.copy() for p in planes], rf,
                                         sigma)
    gabw = np.asarray([0.115169525, 0.061248592] * 3, np.float32)
    dev = TF._filters_chain_device(
        *[p.astype(np.float32) for p in planes],
        sigma.astype(np.float32), True, epf_iters, gabw,
        float(rf.epf_pass0_sigma_scale), float(rf.epf_pass2_sigma_scale))
    for h, d in zip(host, dev):
        assert np.abs(np.asarray(d, np.float64) - h).max() < 2e-5
