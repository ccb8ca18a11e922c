"""chip_smoke.py at tiny sizes on the CPU backend, device path forced:
every phase runs and meets its bound, the four-device phase runs on
the virtual CPU mesh, and the script refuses to start without a GPU."""

import json

import pytest

import chip_smoke


@pytest.fixture(scope="module")
def smoke():
    return chip_smoke.Smoke(uhd=(128, 192), fhd=(64, 96),
                            camera=(96, 128), batch=2, device_env="1",
                            log=lambda s: None)


@pytest.mark.parametrize("phase", ["a", "b", "c", "d", "e", "f"])
def test_phase_small(smoke, phase):
    res = getattr(smoke, "phase_" + phase)()
    assert res["device_s"] > 0
    json.dumps(res)


def test_four_device_phase_virtual_mesh():
    res = chip_smoke.Smoke(fhd=(64, 96), log=lambda s: None).phase_four(
        n_devices=4, frames=8)
    assert res["frames"] == 8 and res["max_diff"] <= 1


def test_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs a GPU" in out.err
