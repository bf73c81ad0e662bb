"""CPU rehearsal of chip_smoke.py: every phase at tiny sizes on the CPU
device (the GPU-vs-CPU comparisons then compare the CPU with itself), and
the refusal to run without a GPU."""
import dataclasses

import jax
import pytest

import chip_smoke

TINY = dataclasses.replace(
    chip_smoke.FULL, res=16, spp=1, max_steps=4, k_volume=1, scene_res=16,
    xl_subdiv=2, xl_spp=1, instances=4, grad_res=8, grad_steps=2, passes=2,
    rays=512, cmp_pixels=64)


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_rehearse_headline_gradient_progressive(tmp_path):
    scene_np, builder = chip_smoke.phase_headline(TINY, str(tmp_path))
    assert (tmp_path / "headline.png").exists()
    chip_smoke.phase_gradient(TINY, scene_np)
    chip_smoke.phase_progressive(TINY, scene_np, builder)


@pytest.mark.parametrize("phase", ["xl", "hair", "instanced"])
def test_rehearse_scene_phase(phase):
    getattr(chip_smoke, "phase_" + phase)(TINY)


def test_rehearse_multi():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual CPU devices (tests/conftest.py)")
    chip_smoke.run_multi(TINY, n_devices=4)
