"""The port's LM server (``repro_torch.launch.serve``'s ``WaveServer`` and
``serve``, the CLI's LM branch, ``examples/serve_lm``) against the
reference's on the CPU.

The reference's parameters are carried across with
``interop.lm_params_from_numpy``; the same requests go through both servers.
Greedy tokens are compared exactly: the f32 SMOKE logits agree to about
1e-6 (``tests/test_torch_lm_models.py``), and the cases below have no
near-ties at the positions served.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_bundle as j_get_bundle
from repro.launch import serve as j_serve
from repro.models import model as JM
from repro_torch import interop
from repro_torch.examples import serve_lm
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as TM

LM_ARCHS = ["smollm-135m", "smollm-360m", "qwen3-0.6b", "starcoder2-15b", "musicgen-large"]
SERVED_FAMILY_ARCHS = ["llama4-scout-17b-a16e", "moonshot-v1-16b-a3b",
                       "jamba-1.5-large-398b", "rwkv6-1.6b"]
VLM = "llama-3.2-vision-90b"


def _carry(cfg):
    jp = JM.init(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, interop.lm_params_from_numpy(tree, cfg, "cpu")


def _requests(mod, cfg, n, max_new, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        shape = (plen, cfg.n_codebooks) if cfg.family == "audio" else (plen,)
        prompt = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
        reqs.append(mod.ServeRequest(rid=i, prompt=prompt, max_new=max_new))
    return reqs


def test_request_and_result_fields_are_the_references_in_order():
    for name in ("ServeRequest", "ServeResult"):
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(t_serve, name))]
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(j_serve, name))]
        assert [g[0] for g in got] == [w[0] for w in want], name
        assert got == want, name
    r = t_serve.ServeRequest(rid=3, prompt=np.arange(4, dtype=np.int32), max_new=2)
    r.out += [5, 6]
    assert t_serve.ServeResult.of(r).out == (5, 6)


@pytest.mark.parametrize("arch,n,slots,max_new,max_len", [
    ("smollm-135m", 6, 4, 12, 64),
    ("smollm-360m", 5, 2, 6, 32),
    ("qwen3-0.6b", 3, 4, 9, 64),
    ("starcoder2-15b", 4, 4, 12, 16),   # max_len cuts the decode at position 15
    ("musicgen-large", 5, 3, 7, 48),    # per-codebook argmax; ``out`` takes codebook 0
    ("llama4-scout-17b-a16e", 6, 4, 12, 64),
    ("moonshot-v1-16b-a3b", 6, 4, 12, 64),
    ("jamba-1.5-large-398b", 5, 2, 8, 32),
    ("rwkv6-1.6b", 6, 4, 12, 64),       # the left-pad zeros run through the state
])
def test_serve_outputs_equal_the_reference_token_for_token(arch, n, slots, max_new, max_len):
    cfg = j_get_bundle(arch).smoke
    jp, tp = _carry(cfg)
    want = j_serve.serve(cfg, jp, _requests(j_serve, cfg, n, max_new), slots=slots,
                         max_len=max_len)
    got = t_serve.serve(cfg, tp, _requests(t_serve, cfg, n, max_new), slots=slots,
                        max_len=max_len, device="cpu")
    assert list(got) == list(want)
    for key in ("n_requests", "requests_served", "decode_steps", "new_tokens", "outputs"):
        assert got[key] == want[key], key
    assert [(r.rid, r.out) for r in got["results"]] == [(r.rid, r.out) for r in want["results"]]
    assert all(r.t_submit <= r.t_first <= r.t_done for r in got["results"])
    if max_len == 16:   # 4-11 token prompts leave at most 15 - plen decode steps
        assert got["new_tokens"] < n * max_new


def test_empty_queue_report_equals_the_references():
    cfg = j_get_bundle("smollm-135m").smoke
    assert t_serve.serve(cfg, {}, [], device="cpu") == j_serve.serve(cfg, {}, [])


def test_wave_left_pads_with_zero_and_fills_with_dummy_clones(monkeypatch):
    cfg = j_get_bundle("musicgen-large").smoke
    _, tp = _carry(cfg)
    reqs = _requests(t_serve, cfg, 5, 3)
    server = t_serve.WaveServer(cfg, tp, slots=4, max_len=32, device="cpu")
    ref = j_serve.WaveServer.__new__(j_serve.WaveServer)
    ref.cfg, ref.slots = cfg, 4
    np.testing.assert_array_equal(server._pad_prompts(reqs[:4]), ref._pad_prompts(reqs[:4]))
    waves = []
    run_wave = t_serve.WaveServer.run_wave

    def spy(self, wave):
        waves.append([(r.rid, r.max_new) for r in wave])
        return run_wave(self, wave)

    monkeypatch.setattr(t_serve.WaveServer, "run_wave", spy)
    stats = t_serve.serve(cfg, tp, reqs, slots=4, max_len=32, device="cpu")
    assert waves == [[(0, 3), (1, 3), (2, 3), (3, 3)], [(4, 3), (-1, 1), (-1, 1), (-1, 1)]]
    assert [r.rid for r in stats["results"]] == [0, 1, 2, 3, 4]
    assert stats["decode_steps"] == 4 and stats["new_tokens"] == 15


def test_caller_stamped_submit_time_is_kept():
    cfg = j_get_bundle("smollm-135m").smoke
    _, tp = _carry(cfg)
    reqs = _requests(t_serve, cfg, 2, 2)
    reqs[0].t_submit = 1.0
    stats = t_serve.serve(cfg, tp, reqs, slots=2, device="cpu")
    assert stats["results"][0].t_submit == 1.0 and stats["results"][1].t_submit > 1.0


def test_cli_serves_the_default_arch_smoke_on_the_cpu(capsys):
    """No ``--arch``: the reference's default, smollm-135m; the param-count
    line is the reference's."""
    stats = t_serve.main(["--smoke", "--device", "cpu"])
    port_out = capsys.readouterr().out
    j_serve.main(["--smoke"])
    ref_out = capsys.readouterr().out
    assert port_out.splitlines()[0] == ref_out.splitlines()[0] == \
        "serving smollm-135m-smoke: 77,040 params, 4 slots, 6 requests"
    assert [ln.split(":")[0] for ln in port_out.splitlines()] == \
        [ln.split(":")[0] for ln in ref_out.splitlines()]
    assert (stats["n_requests"], stats["new_tokens"], stats["decode_steps"]) == (6, 72, 22)


def test_cli_profile_prints_device_time_and_writes_a_trace(tmp_path, capsys):
    stats = t_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                          "--requests", "2", "--max-new", "3", "--profile", str(tmp_path)])
    out = capsys.readouterr().out
    assert "profile: wall " in out and "device busy" in out
    assert (tmp_path / "serve_trace.json").stat().st_size > 0
    assert stats["new_tokens"] == 6


def test_example_serve_lm_smoke_runs(capsys):
    stats = serve_lm.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served all requests" in out
    assert stats["n_requests"] == 6 and stats["new_tokens"] == 48


@pytest.mark.parametrize("arch", SERVED_FAMILY_ARCHS)
def test_cli_serves_the_moe_hybrid_and_rwkv_smokes_on_the_cpu(arch, capsys):
    """``--arch <a> --smoke --device cpu``: the reference's param-count line
    and the CLI's defaults (6 requests of 12 new tokens, 4 slots)."""
    stats = t_serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    cfg = j_get_bundle(arch).smoke
    assert out[0] == f"serving {cfg.name}: {JM.n_params(cfg):,} params, 4 slots, 6 requests"
    assert (stats["n_requests"], stats["new_tokens"]) == (6, 72)
    assert "new_tokens: 72" in out


def test_vlm_is_refused_naming_the_references_fault(capsys):
    """The reference's ``WaveServer`` prefills without ``vision_embeds``, so
    its vlm serve fails; the port refuses the family in the CLI (before
    drawing anything) and in ``serve()``, naming that fault."""
    for argv in (["--arch", VLM, "--smoke", "--device", "cpu"], ["--arch", VLM]):
        with pytest.raises(SystemExit) as exc:
            t_serve.main(argv)
        msg = str(exc.value)
        assert msg.startswith(f"{VLM}: ") and "src/repro/launch/serve.py:174" in msg
        assert "src/repro/models/attention.py:255" in msg and "ROADMAP A.7b" not in msg
    assert capsys.readouterr().out == ""
    cfg = j_get_bundle(VLM).smoke
    _, tp = _carry(cfg)
    with pytest.raises(NotImplementedError, match="vision_proj None"):
        t_serve.serve(cfg, tp, _requests(t_serve, cfg, 2, 2), device="cpu")


def test_the_references_cli_fails_on_the_vlm_smoke(capsys):
    """The record of the reference's fault: its CLI serves the vlm SMOKE
    into ``AttributeError`` at ``project_vision_kv``."""
    with pytest.raises(AttributeError, match="'NoneType' object has no attribute 'shape'") \
            as exc:
        j_serve.main(["--arch", VLM, "--smoke"])
    assert any(f.name == "project_vision_kv" for f in exc.traceback)
    capsys.readouterr()


def test_example_serve_lm_takes_no_arch():
    """``examples/serve_lm`` serves smollm-135m only: an ``--arch`` reaches
    the CLI through ``serve_mod.main`` alone."""
    with pytest.raises(SystemExit) as exc:
        serve_lm.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu"])
    assert exc.value.code == 2


def test_wave_server_runs_bf16_on_the_cpu():
    """The FULL configs' dtype, at smoke width: the server keeps the model
    dtype and serves every token."""
    cfg = dataclasses.replace(j_get_bundle("smollm-135m").smoke, dtype="bfloat16")
    params = TM.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert params["embed"].dtype == torch.bfloat16
    stats = t_serve.serve(cfg, params, _requests(t_serve, cfg, 3, 4), slots=2, device="cpu")
    assert stats["new_tokens"] == 12
    assert all(0 <= t < cfg.vocab_size for r in stats["results"] for t in r.out)
