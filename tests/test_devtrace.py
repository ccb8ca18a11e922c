"""jxl_coder.utils.devtrace on a small recorded CPU trace and on
synthetic events."""

import jax
import jax.numpy as jnp
import pytest

from jxl_coder.utils import devtrace as D


def test_split_recorded_trace_by_scope(tmp_path):
    @jax.jit
    def f(x):
        with jax.named_scope("stage_a"):
            y = jnp.sin(x) @ x
        with jax.named_scope("stage_b"):
            return jnp.cos(y) * 2.0

    x = jnp.ones((128, 128), jnp.float32)
    scopes = D.hlo_scopes(f.lower(x).compile().as_text())
    assert any("stage_a" in v for v in scopes.values())
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    events = D.op_events(D.xplane_path(str(tmp_path)), "/host:CPU")
    split = D.split_by_scope(events, scopes, ("stage_a", "stage_b"))
    assert split.get("stage_a", 0) > 0 and split.get("stage_b", 0) > 0
    assert D.busy_ns(events) <= sum(e.dur_ns for e in events)


def test_kernel_name_stands_in_for_command_buffer():
    scopes = {"loop_add_fusion.3": "jit(f)/filters/add"}
    ev = D.OpEvent("command_buffer", 0.0, 5.0, "loop_add_fusion_3")
    lib = D.OpEvent("command_buffer", 5.0, 2.0, "sm80_xmma_gemm_f32")
    assert D.op_name_of(ev, scopes) == "jit(f)/filters/add"
    assert D.split_by_scope([ev, lib], scopes, ("filters",)) == {
        "filters": 5.0, "unmapped": 2.0}


def test_busy_is_union_of_intervals():
    evs = [D.OpEvent("a", 0.0, 10.0), D.OpEvent("b", 5.0, 10.0),
           D.OpEvent("c", 30.0, 5.0)]
    assert D.busy_ns(evs) == 20.0


def test_xplane_path_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        D.xplane_path(str(tmp_path))
