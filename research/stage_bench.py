"""Fast-iteration stage bench: device reconstruction throughput on the
real parsed 4K state (the bench.py stage metric), with the parsed state
pickled to .bench_cache/ so reruns skip the host entropy decode."""

import os
import pickle
import sys
import time

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)
os.environ.setdefault("JXL_DEVICE", "1")

import numpy as np

STATE_CACHE = os.path.join(REPO, ".bench_cache", "bench4k_state.pkl")
STREAM_CACHE = os.path.join(REPO, ".bench_cache", "bench4k_v2.jxl")
W, H = 3840, 2160
K = 16


def get_state():
    if os.path.exists(STATE_CACHE):
        with open(STATE_CACHE, "rb") as f:
            return pickle.load(f)
    from jxl_coder.bitstream.reader import BitReader
    from jxl_coder.bitstream import container as container_mod
    from jxl_coder.bitstream.headers import read_image_header
    from jxl_coder.bitstream.frame_header import (read_frame_header,
                                                      read_toc)
    from jxl_coder.vardct import dec_real
    data = open(STREAM_CACHE, "rb").read()
    cs = container_mod.extract_codestream(data).codestream
    br = BitReader(cs)
    hdr = read_image_header(br)
    fh = read_frame_header(br, hdr)
    ng, ndc = fh.counts(hdr)
    n = 1 if (ng == 1 and fh.passes.num_passes == 1) else (
        2 + ndc + ng * fh.passes.num_passes)
    toc = read_toc(br, n)
    state = {}
    dec_real.decode_vardct_frame(cs, hdr, fh, toc, state_out=state)
    try:
        with open(STATE_CACHE, "wb") as f:
            pickle.dump(state, f)
    except Exception as e:
        print("state pickle failed:", e, file=sys.stderr)
    return state


def main():
    import jax
    import jax.numpy as jnp
    from jxl_coder import backend
    backend.use_compile_cache()

    from jxl_coder.vardct import device_full as TF
    state = get_state()
    lf, fh = state["lf"], state["fh"]
    t0 = time.perf_counter()
    desc, fams, qm, perm_inv = TF.prepare_families(
        lf, fh, state["blocks_glob"], state["qf_map"],
        state["ytox_glob"], state["ytob_glob"])
    print(f"prepare_families: {time.perf_counter() - t0:.3f}s")
    ys_b, xs_b = state["qf_map"].shape
    rf = fh.restoration_filter
    gabw = (tuple(float(g) for g in rf.gab_weights)
            if rf.gab and rf.gab_custom and rf.gab_weights is not None
            else (0.115169525, 0.061248592) * 3)
    fn = TF._compiled(desc, ys_b * 8, xs_b * 8, int(state["bits"]),
                      bool(rf.gab), int(rf.epf_iters), gabw,
                      float(rf.epf_pass0_sigma_scale),
                      float(rf.epf_pass2_sigma_scale),
                      int(state["h"]), int(state["w"]))
    dc = jnp.asarray(np.stack([state["dc_glob"][c] for c in range(3)])
                     .astype(np.float32))
    qf = jnp.asarray(state["qf_map"].astype(np.int32))
    sharp = jnp.asarray(state["sharp_map"].astype(np.int32))
    igs = np.float32(lf.inv_global_scale)
    fams_d = jax.device_put(fams)
    qm_d = jnp.asarray(qm)
    perm_d = jnp.asarray(perm_inv)

    @jax.jit
    def run_k(fams_, dc_, qf_, sharp_, qm_, perm_):
        def body(carry, i):
            dc2 = dc_ + i.astype(jnp.float32) * 1e-6
            o = fn(fams_, dc2, qf_, sharp_, igs, qm_, perm_)
            return carry + jnp.sum(o.astype(jnp.uint32)), None
        total, _ = jax.lax.scan(body, jnp.uint32(0), jnp.arange(K))
        return total

    t0 = time.perf_counter()
    _ = int(run_k(fams_d, dc, qf, sharp, qm_d, perm_d))
    print(f"compile+warm: {time.perf_counter() - t0:.1f}s")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _ = int(run_k(fams_d, dc, qf, sharp, qm_d, perm_d))
        best = min(best, (time.perf_counter() - t0) / K)
    print(f"stage: {best * 1e3:.2f} ms/frame  {W * H / best / 1e6:.1f} MP/s")

    if os.environ.get("CHECK", "1") != "0":
        # correctness vs the host path on the true-size crop
        out = TF.reconstruct_state_device(state)
        ref = state.get("host_out")
        if ref is None:
            print("(no host_out in state; skipping diff)")
        else:
            d = np.abs(out.astype(np.int32) - ref.astype(np.int32))
            print(f"max abs diff vs host: {d.max()}")


if __name__ == "__main__":
    main()
