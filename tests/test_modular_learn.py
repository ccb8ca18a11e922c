"""Encoder-side MA learning: native helpers vs the Python oracles."""

import numpy as np
import pytest


def test_wp_forward_native_matches_python():
    """The native forward-WP pass (hostcodec.cpp wp_forward) must match
    the Python oracle exactly — prediction and property planes."""
    from jxl_coder.modular import learn
    import jxl_coder.native as nm
    if nm.get_lib() is None:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(7)
    for shape in ((1, 1), (3, 1), (1, 5), (37, 53), (64, 64)):
        D = rng.integers(-30000, 30000, shape).astype(np.int64)
        native = learn.wp_planes(D)
        real_get = nm.get_lib
        nm.get_lib = lambda: None
        try:
            py = learn.wp_planes(D)
        finally:
            nm.get_lib = real_get
        assert np.array_equal(native[0], py[0]), shape
        assert np.array_equal(native[1], py[1]), shape


def test_native_whole_node_split_matches_oracle():
    """ma_best_split_native must reproduce the numpy _learn_node search
    EXACTLY (same quantile rule, tie order and costs -> identical
    trees)."""
    import numpy as np
    from jxl_coder.modular import learn as L
    from jxl_coder.modular.image import Channel
    from jxl_coder import native as NM
    if NM.get_lib() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(0)
    for _trial in range(3):
        h, w = int(rng.integers(40, 100)), int(rng.integers(40, 100))
        base = rng.integers(0, 200, (h, w)).astype(np.int32)
        base[h // 3:, :] += 300
        chans = [Channel(w, h, data=base + rng.integers(
            0, 9, (h, w)).astype(np.int32)) for _ in range(3)]
        t1 = L.learn_tree(chans, max_leaves=12)
        lib = NM._lib
        NM._lib = None
        try:
            t2 = L.learn_tree(chans, max_leaves=12)
        finally:
            NM._lib = lib
        s1 = [(n.property, n.splitval, n.predictor, n.ctx)
              for n in t1.nodes]
        s2 = [(n.property, n.splitval, n.predictor, n.ctx)
              for n in t2.nodes]
        assert s1 == s2
