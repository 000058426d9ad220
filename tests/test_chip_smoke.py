"""chip_smoke.py — the GPU bring-up run — exercised on the CPU test mesh
at tiny widths: the same phase functions, the same checks (exactly-once
delivery, bit-exact words and frame bits, the call timeline, sharded ==
single-device), and its refusal to run without a GPU."""

import json
import os

import jax
import pytest

import chip_smoke
from amps_tpu.utils import compile_cache


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def test_main_refuses_to_run_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    assert _last_json(out)["ok"] is False


def test_bank_phase_against_float64():
    res = chip_smoke.phase_bank(num_channels=32, hops=64)
    assert res["snr_db"]["bf16"] >= chip_smoke.SNR_FLOOR_DB["bf16"]
    # f32 on the CPU is exact f32, far above the TF32 floor
    assert res["snr_db"]["f32"] > 120


def test_rx_phase_exactly_once():
    res = chip_smoke.phase_rx(num_channels=32, n_events=8,
                              total_hops=40000, block=16 * 4096)
    assert res["ok"] and res["exact_once"] == 8
    assert not res["ghosts"] and not res["misdecodes"]


def test_loop_phase_decodes_planted_words():
    res = chip_smoke.phase_loop(num_channels=32, nblocks=3, n_events=6)
    assert res["ok"] and res["exact_once"] == res["n_events"] == 6
    assert res["focc_frame_bits_mismatched"] == 0


def test_bs_phase_operator_page_and_live_call():
    res = chip_smoke.phase_bs(channels=16, call_channels=8)
    assert res["operator_page"]
    assert res["call"]["timeline"] == chip_smoke.CALL_TIMELINE


def test_four_phase_sharded_matches_single_device():
    assert len(jax.devices()) >= 4
    res = chip_smoke.phase_four(num_channels=16, n_random=6,
                                call_channels=8)
    assert res["reports_equal_single_device"]
    assert res["exact_once"] == res["n_events"]
    assert res["tx_max_abs_err"] <= res["tx_tolerance"]
    assert [c["mesh"] for c in res["calls"]] == ["2x2", "1x1"]


def test_four_option_runs_only_the_four_card_phase(monkeypatch, capsys):
    """--four runs the sharded phase and nothing else, and the last
    line counts the devices JAX reports."""
    from amps_tpu.utils import device
    monkeypatch.setattr(device, "gpu_devices", lambda count=1: [])
    monkeypatch.setattr(device, "gpu_name_and_power", lambda: "card, 1 W")
    ran = []
    for name in ("bank", "rx", "loop", "bs", "memory", "four"):
        monkeypatch.setattr(chip_smoke, f"phase_{name}",
                            lambda name=name: ran.append(name) or {})
    assert chip_smoke.main(["--four"]) == 0
    out = capsys.readouterr().out
    assert ran == ["four"]
    phases = [json.loads(ln)["phase"] for ln in out.splitlines()
              if ln.startswith('{"phase"')]
    assert phases == ["device", "four"]
    assert _last_json(out) == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}


@pytest.mark.parametrize("env", [{"JAX_COMPILATION_CACHE_DIR": "/x/cache"},
                                 {}], ids=["env_set", "env_unset"])
def test_compile_cache_dir(env):
    """JAX_COMPILATION_CACHE_DIR, when set, is the only directory;
    otherwise <checkout>/.jax_cache, from the package's own path."""
    got = compile_cache.cache_dir(env)
    if env:
        assert got == "/x/cache"
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")


@pytest.mark.chip
def test_chip_smoke_on_gpu(gpu):
    """The whole one-card bring-up run (python chip_smoke.py)."""
    assert chip_smoke.main([]) == 0
