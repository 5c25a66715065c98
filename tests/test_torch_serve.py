"""The port's diffusion serving against the JAX engine: the same request
stream must give the same admissions, waves and simulated clock, and the
same denoised latents (max-abs <= 2e-5, as ``tests/test_serve.py`` holds
the JAX engine to single-clip sampling)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.core.cost_model import CostModel as JaxCostModel  # noqa: E402
from repro.models import mmdit as M  # noqa: E402
from repro.serve import ContinuousBatchingScheduler as JaxScheduler  # noqa: E402
from repro.serve import DenoiseRequest as JaxRequest  # noqa: E402
from repro.serve import DiffusionServeEngine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.convert import from_jax_params  # noqa: E402
from repro_torch.core.cost_model import CostModel  # noqa: E402
from repro_torch.launch import profile_serve  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.mmdit import MMDiT  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousBatchingScheduler,
    DenoiseRequest,
    DiffusionServeEngine,
    ServeConfig,
)

MODEL = dict(a=0.01, b=1e-6, p=2.0, r2=1.0)
SERVE = dict(target_step=0.5, page_size=8, num_pages=64, decode_slots=2, max_seq=24)


def _stream(cfg, n=3, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s_vis = int(rng.integers(8, 25))
        lat = rng.standard_normal((s_vis, cfg.in_channels * 4)).astype(np.float32)
        txt = rng.standard_normal((cfg.text_len, 4096)).astype(np.float32)
        out.append((lat, txt, 2 + (i % 2), 0.004 * i))
    return out


def _records(eng):
    return [(it["admitted"], it["wave"], it["clock"], it["oversize"]) for it in eng.iterations]


def test_engine_matches_jax_engine():
    cfg = get_smoke_config("wan2.1-1.3b")
    params = M.init_params(jax.random.PRNGKey(1), cfg)
    mmdit = MMDiT(cfg, device="cpu")
    mmdit.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg, device="cpu"))
    eng_j = JaxEngine(params, cfg, JaxCostModel(**MODEL), JaxServeConfig(**SERVE))
    eng_t = DiffusionServeEngine(mmdit, cfg, CostModel(**MODEL), ServeConfig(**SERVE))
    for lat, txt, n_steps, arrival in _stream(cfg):
        eng_j.submit(lat, txt, n_steps, arrival=arrival)
        eng_t.submit(lat, txt, n_steps, arrival=arrival)
    done_j, done_t = eng_j.run(), eng_t.run()
    assert _records(eng_t) == _records(eng_j)
    assert [r.rid for r in done_t] == [r.rid for r in done_j]
    # at least one wave ran two clips of different lengths side by side
    assert any(len(it["wave"]) == 2 for it in eng_t.iterations)
    for rj, rt in zip(done_j, done_t):
        assert (rt.t_first, rt.t_done) == (rj.t_first, rj.t_done)
        err = float(np.max(np.abs(rt.result - rj.result)))
        assert err <= 2e-5, f"request {rt.rid}: err {err}"


@pytest.mark.parametrize("target_step", [0.02, 0.2, 2.0])
def test_scheduler_plans_match_jax(target_step):
    """Both schedulers admit the same FCFS prefixes, including oversize
    requests, under the same (M_comp, token, slot) budgets."""
    rng = np.random.default_rng(int(target_step * 100))
    lens = [int(n) for n in rng.integers(8, 400, size=12)]
    cfg = dict(target_step=target_step, page_size=16, num_pages=64, decode_slots=3,
               max_seq=512)
    sched_j = JaxScheduler(JaxCostModel(**MODEL), JaxServeConfig(**cfg))
    sched_t = ContinuousBatchingScheduler(CostModel(**MODEL), ServeConfig(**cfg))
    mk = {
        "j": lambda i, n: JaxRequest(i, np.zeros((n, 1), np.float32), np.zeros((1, 1)), 1),
        "t": lambda i, n: DenoiseRequest(i, np.zeros((n, 1), np.float32), np.zeros((1, 1)), 1),
    }
    for side, sched in (("j", sched_j), ("t", sched_t)):
        waiting = [mk[side](i, n) for i, n in enumerate(lens)]
        running, plans = [], []
        while waiting:
            free = 64 * 16 - sum(-(-r.tokens // 16) * 16 for r in running)
            plan = sched.plan(waiting, running, free_tokens=free, free_slots=3 - len(running))
            plans.append(([r.rid for r in plan.prefills], plan.decode_load,
                          plan.prefill_load, plan.oversize, sched.price(plan)))
            for r in plan.prefills:
                waiting.remove(r)
            running = plan.prefills or running[1:]
        if side == "j":
            plans_j = plans
    assert plans == plans_j


def test_launcher_runs_on_cpu_and_needs_a_device(monkeypatch, capsys):
    eng = launch_serve.main(["--arch", "wan2.1-1.3b", "--smoke", "--device", "cpu",
                             "--requests", "2", "--max-seq", "32", "--denoise-steps", "2"])
    assert len(eng.done) == 2 and all(np.isfinite(r.result).all() for r in eng.done)
    assert "served 2 denoise requests" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "wan2.1-1.3b", "--smoke"])


def test_profile_breakdown_families_and_idle_share(monkeypatch):
    kernels = [
        ("void flash_fwd_kernel<__nv_bfloat16, 128>(Params)", 0.0, 40.0),
        ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNT", 30.0, 60.0),  # overlaps
        ("void adaln_fwd_kernel<__nv_bfloat16>(...)", 70.0, 80.0),
        ("void at::native::vectorized_elementwise_kernel<4, ...>", 90.0, 100.0),
    ]
    out = profile_serve.breakdown(kernels)
    assert out["device_ms_by_family"] == {
        "K1 adaln_fwd": 0.01, "K7 flash_fwd": 0.04,
        "elementwise / reduce": 0.01, "matmul (cuBLAS)": 0.03,
    }
    assert out["busy_ms"] == pytest.approx(0.08) and out["window_ms"] == pytest.approx(0.1)
    assert out["idle_share"] == pytest.approx(0.2)
    # the LM route's kernels: K4 on rows is not the q/k entry, K12 its own
    assert profile_serve.family("void (anonymous namespace)::rms_fwd_kernel<float>(...)") \
        == "K4 rms_fwd (rows)"
    assert profile_serve.family("void qk_rms_fwd_kernel<__nv_bfloat16, 64>(Side, Side)") \
        == "K4 qk_rms_fwd"
    for k12 in ("void (anonymous namespace)::paged_decode_chunk_kernel<__nv_bfloat16, 64>"
                "(PagedParams)", "void paged_decode_chunk_kernel<float, 128>(PagedParams)"):
        assert profile_serve.family(k12) == "K12 paged_decode"
    assert profile_serve.family("void gemv2T_kernel_val<int, int, __nv_bfloat16>") \
        == "matmul (cuBLAS)"
    # K7's two kernels: the warp-specialised bf16 one and the f32 one
    for k7 in ("void (anonymous namespace)::wg::flash_fwd_wg_kernel<float, 64>(Params)",
               "void (anonymous namespace)::flash_fwd_f32_kernel<128>(Params)"):
        assert profile_serve.family(k7) == "K7 flash_fwd"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_serve.main(["--arch", "llama3.2-1b"])


def test_profile_lm_workload_runs_on_cpu():
    """The LM route's two profiled iterations, at the smoke size on the CPU:
    eight resident requests at their own depths, one decode wave, one
    prefill into pages no request holds."""
    from repro_torch.configs.registry import get_smoke_config

    cfg = get_smoke_config("llama3.2-1b")
    decode_wave, prefill, eng = profile_serve.lm_workload(
        cfg, "cpu", prompts=(5, 9, 16, 40), prefill=32)
    depths = eng.kv_lens.copy()
    assert not eng.waiting and all(r is not None for r in eng.slot_req)
    assert len(set(depths.tolist())) == 4
    assert decode_wave()
    assert (eng.kv_lens == depths + 1).all()
    logits, _ = prefill()
    assert logits.shape == (1, cfg.vocab) and torch.isfinite(logits).all()
