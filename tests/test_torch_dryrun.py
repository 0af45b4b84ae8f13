"""The port's dry run (``repro_torch.launch.dryrun``) against the reference's.

Counterparts of ``tests/test_dryrun_integration.py`` and
``tests/test_system.py::test_dryrun_matrix_has_32_baseline_cells``: the
32-cell matrix and its names equal the reference's; ``n_active_params``
equals the reference's for the ten archs; in child processes (each makes
its own fake world of 256 or 512 ranks, which must not outlive it),
qwen3-0.6b decode_32k traces on both meshes with an ``ok`` artifact whose
argument and temp bytes fit an H100's 80 GB (the reference asserts v5e's
16 GB), rule overrides reach the artifact, and smollm-135m decode_32k
agrees exactly with the reference's own artifact on both meshes in
``n_chips``, ``n_params``, ``n_active_params``, ``argument_size_in_bytes``
and ``flops_per_device``. Attention is laid out as the reference lays it
out: qwen3-0.6b prefill_32k on (16, 16) computes within 1.25x of the
reference's FLOPs a device and its first product over its even share (if
any) is not attention's, and smollm-135m decode_32k's collective bytes a
device are within 4x of the reference's on both meshes. The MoE FFN, the
router and the mamba block are laid out as the reference lays them out:
moonshot-v1-16b-a3b and jamba-1.5-large-398b prefill_32k on (16, 16) compute
within 1.10x of the reference's FLOPs a device, with no product of
``models/ffn.py``, ``models/ssm.py`` or ``models/model.py`` over its share;
rwkv6-1.6b prefill_32k computes the reference's FLOPs a device within 2 %,
its products over their share those the reference replicates too, and its
train_4k runs the WKV recurrence on each rank's own heads. A train step's
memory is laid out as the reference's: smollm-135m and qwen3-0.6b train_4k
on (16, 16) move their logits by an all-to-all, their temp (outputs left
out, as XLA's) lies within 1.5x of the reference's, their FLOPs a device
are the reference's exactly, and no storage alive at the temp's peak holds
the vocab whole over the whole sequence. The children run at once, three
at a time.
"""
import concurrent.futures
import json
import os
import subprocess
import sys

import pytest

from repro_torch.configs import ASSIGNED_ARCHS, get_bundle
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_HBM = 80 * 10 ** 9
MESHES = [False, True]


def _reference_dryrun():
    """The reference's module, imported with the environment it sets at
    import (512 placeholder devices for its own children) put back."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as j_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return j_dryrun


def test_matrix_has_the_references_32_cells():
    j_dryrun = _reference_dryrun()
    cells = dryrun.all_cells()
    assert cells == j_dryrun.all_cells()
    assert len(cells) == 64 and len({(a, s) for a, s, _ in cells}) == 32
    assert [dryrun.cell_name(*c) for c in cells] == [j_dryrun.cell_name(*c) for c in cells]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_n_active_params_equal_the_references(arch):
    from repro import configs as j_configs

    j_dryrun = _reference_dryrun()
    assert dryrun.n_active_params(get_bundle(arch).model) == j_dryrun.n_active_params(
        j_configs.get_bundle(arch).model)


# ---------------------------------------------------------------------------
# cells in child processes

_PORT = {
    "qwen3/16x16": ["--arch", "qwen3-0.6b", "--shape", "decode_32k"],
    "qwen3/2x16x16": ["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--multi-pod"],
    "smollm/16x16": ["--arch", "smollm-135m", "--shape", "decode_32k"],
    "smollm/2x16x16": ["--arch", "smollm-135m", "--shape", "decode_32k", "--multi-pod"],
    "overrides": ["--arch", "smollm-135m", "--shape", "decode_32k",
                  "--rule-overrides", '{"kv_seq": "data"}', "--tag", "t1"],
    "qwen3-prefill/16x16": ["--arch", "qwen3-0.6b", "--shape", "prefill_32k"],
    "moonshot-prefill/16x16": ["--arch", "moonshot-v1-16b-a3b", "--shape", "prefill_32k"],
    "jamba-prefill/16x16": ["--arch", "jamba-1.5-large-398b", "--shape", "prefill_32k"],
    "rwkv6-prefill/16x16": ["--arch", "rwkv6-1.6b", "--shape", "prefill_32k"],
    "rwkv6-train/16x16": ["--arch", "rwkv6-1.6b", "--shape", "train_4k"],
    "smollm-train/16x16": ["--arch", "smollm-135m", "--shape", "train_4k"],
    "qwen3-train/16x16": ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
}
_REFERENCE = {
    "ref/16x16": ["--arch", "smollm-135m", "--shape", "decode_32k"],
    "ref/2x16x16": ["--arch", "smollm-135m", "--shape", "decode_32k", "--multi-pod"],
    "ref/qwen3-prefill/16x16": ["--arch", "qwen3-0.6b", "--shape", "prefill_32k"],
    "ref/moonshot-prefill/16x16": ["--arch", "moonshot-v1-16b-a3b", "--shape", "prefill_32k"],
    "ref/jamba-prefill/16x16": ["--arch", "jamba-1.5-large-398b", "--shape", "prefill_32k"],
    "ref/rwkv6-prefill/16x16": ["--arch", "rwkv6-1.6b", "--shape", "prefill_32k"],
    "ref/smollm-train/16x16": ["--arch", "smollm-135m", "--shape", "train_4k"],
    "ref/qwen3-train/16x16": ["--arch", "qwen3-0.6b", "--shape", "train_4k"],
}
FLOPS_SLACK = 1.25        # train and prefill FLOPs a device against the reference's
MOE_FLOPS_SLACK = 1.10    # the MoE and hybrid cells' FLOPs a device against the reference's
# The frames whose products must keep their even share: the MoE FFN and its
# router, the mamba block, the vision projection.
LAID_OUT = ("models/ffn.py", "models/ssm.py", "models/model.py")
RWKV_FLOPS_SLACK = 1.02   # rwkv6's FLOPs a device against the reference's
COLLECTIVE_SLACK = 4.0    # decode's collective bytes a device against the reference's
TEMP_SLACK = 1.5          # a train step's temp a device against the reference's


def _run(key, tmp):
    port = key in _PORT
    out = os.path.join(tmp, key.replace("/", "_"))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    if port:
        cmd = ["-m", "repro_torch.launch.dryrun", *_PORT[key], "--device", "cpu"]
    else:
        env["JAX_PLATFORMS"] = "cpu"
        cmd = ["-m", "repro.launch.dryrun", *_REFERENCE[key]]
    r = subprocess.run([sys.executable, *cmd, "--out", out], capture_output=True, text=True,
                       env=env, cwd=ROOT, timeout=900)
    return key, r, out


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dryrun"))
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(lambda k: _run(k, tmp), [*_PORT, *_REFERENCE]))
    return {key: (r, out) for key, r, out in runs}


def _artifact(cells, key, name):
    r, out = cells[key]
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(os.path.join(out, name)) as f:
        return json.load(f)


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
def test_decode_cell_traces(cells, multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    rec = _artifact(cells, f"qwen3/{mesh}", dryrun.cell_name("qwen3-0.6b", "decode_32k",
                                                              multi_pod) + ".json")
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["n_chips"] == (512 if multi_pod else 256)
    assert rec["hlo_cost"]["flops_per_device"] > 0
    mem = (rec["memory_analysis"]["temp_size_in_bytes"]
           + rec["memory_analysis"]["argument_size_in_bytes"])
    assert mem < H100_HBM, f"decode cell uses {mem / 1e9:.1f} GB"
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "n_chips", "seq_len",
                        "global_batch", "n_params", "n_active_params", "parallel", "tag",
                        "timings", "memory_analysis", "cost_analysis_raw", "hlo_cost"}


def test_rule_overrides_flow_through(cells):
    """Hillclimb overrides reach the layout (the artifact records them)."""
    rec = _artifact(cells, "overrides", "smollm-135m__decode_32k__singlepod.t1.json")
    assert rec["parallel"]["rule_overrides"] == {"kv_seq": "data"}
    assert rec["tag"] == "t1"
    plain = _artifact(cells, "smollm/16x16", "smollm-135m__decode_32k__singlepod.json")
    assert rec["hlo_cost"] != plain["hlo_cost"]


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
def test_smollm_decode_equals_the_references_artifact(cells, multi_pod):
    mesh = "2x16x16" if multi_pod else "16x16"
    name = dryrun.cell_name("smollm-135m", "decode_32k", multi_pod) + ".json"
    port = _artifact(cells, f"smollm/{mesh}", name)
    ref = _artifact(cells, f"ref/{mesh}", name)
    for key in ("n_chips", "n_params", "n_active_params", "arch", "shape", "mesh", "kind",
                "seq_len", "global_batch", "parallel"):
        assert port[key] == ref[key], key
    assert port["memory_analysis"]["argument_size_in_bytes"] \
        == ref["memory_analysis"]["argument_size_in_bytes"]
    assert port["hlo_cost"]["flops_per_device"] == ref["hlo_cost"]["flops_per_device"]


def test_prefill_flops_are_the_references_and_attention_keeps_its_share(cells):
    """qwen3-0.6b prefill_32k on (16, 16): the score and value products run
    on each rank's own (batch, heads) block and K/V are projected over
    ``kv_seq``, so the FLOPs a device come within ``FLOPS_SLACK`` of the
    reference's (15x above them while the heads were gathered) and no
    product of attention computes more than its even share."""
    name = dryrun.cell_name("qwen3-0.6b", "prefill_32k", False) + ".json"
    port = _artifact(cells, "qwen3-prefill/16x16", name)
    ref = _artifact(cells, "ref/qwen3-prefill/16x16", name)
    ratio = port["hlo_cost"]["flops_per_device"] / ref["hlo_cost"]["flops_per_device"]
    assert 1 / FLOPS_SLACK <= ratio <= FLOPS_SLACK, ratio
    dep = port["layout"]["departures"]
    assert dep["matched"], dep
    first = dep["first"]
    assert first is None or not any("models/attention.py" in f for f in first["stack"]), first


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-1.5-large-398b"],
                         ids=["moonshot", "jamba"])
def test_moe_and_mamba_keep_their_share(cells, arch):
    """moonshot-v1-16b-a3b (MoE) and jamba-1.5-large-398b (mamba + MoE)
    prefill_32k on (16, 16): the router, the dispatch, the expert products
    and the combine run on each rank's own (groups, experts) block, and the
    mamba block reduces ``dt`` before ``dt_proj`` multiplies it by the rank's
    own ``d_inner`` columns. The FLOPs a device come within
    ``MOE_FLOPS_SLACK`` of the reference's (1.46x and 1.12x while the groups
    were gathered) and no product of ``models/ffn.py``, ``models/ssm.py`` or
    ``models/model.py`` computes more than its even share (``sites``)."""
    key = {"moonshot-v1-16b-a3b": "moonshot-prefill", "jamba-1.5-large-398b": "jamba-prefill"}[arch]
    name = dryrun.cell_name(arch, "prefill_32k", False) + ".json"
    port = _artifact(cells, f"{key}/16x16", name)
    ref = _artifact(cells, f"ref/{key}/16x16", name)
    ratio = port["hlo_cost"]["flops_per_device"] / ref["hlo_cost"]["flops_per_device"]
    assert 1 / MOE_FLOPS_SLACK <= ratio <= MOE_FLOPS_SLACK, ratio
    dep = port["layout"]["departures"]
    assert dep["matched"], dep
    assert "sites" in dep
    laid = [s for s in dep["sites"] if any(f in s["frame"] for f in LAID_OUT)]
    assert not laid, laid


def test_rwkv6_time_mix_replicates_what_the_reference_replicates(cells):
    """rwkv6-1.6b prefill_32k on (16, 16): the decay's LoRA up-projection
    computes each rank's own ``d_inner`` columns, as the reference's does,
    and the products left over their even share are those whose weights
    the rules replicate on every ``model`` rank in the reference as well
    (the mix and decay LoRAs' ``w1`` / ``w2`` / ``wd1`` and the channel
    mix's ``wr``): the FLOPs a device are the reference's within 2 %, and
    every site over its share lies in the time mix or the channel mix."""
    name = dryrun.cell_name("rwkv6-1.6b", "prefill_32k", False) + ".json"
    port = _artifact(cells, "rwkv6-prefill/16x16", name)
    ref = _artifact(cells, "ref/rwkv6-prefill/16x16", name)
    ratio = port["hlo_cost"]["flops_per_device"] / ref["hlo_cost"]["flops_per_device"]
    assert 1 / RWKV_FLOPS_SLACK <= ratio <= RWKV_FLOPS_SLACK, ratio
    sites = port["layout"]["departures"]["sites"]
    assert sites and all(s["frame"].endswith(("rwkv_time_mix", "rwkv_channel_mix"))
                         for s in sites), sites


def test_rwkv6_train_runs_the_recurrence_on_each_ranks_heads(cells):
    """rwkv6-1.6b train_4k on (16, 16), whose activations split the
    sequence over ``model`` (Megatron-SP): the WKV recurrence runs on each
    rank's own heads over the whole sequence, as the reference's does, so
    no product computes more than its even share (its per-step product ran
    on every head of every ``model`` rank, x16)."""
    name = dryrun.cell_name("rwkv6-1.6b", "train_4k", False) + ".json"
    dep = _artifact(cells, "rwkv6-train/16x16", name)["layout"]["departures"]
    assert dep["matched"] and dep["sites"] == [], dep


@pytest.mark.parametrize("multi_pod", MESHES, ids=["16x16", "2x16x16"])
def test_smollm_decode_collectives_are_near_the_references(cells, multi_pod):
    """smollm-135m decode_32k: each rank writes the step's K/V row into its
    own ``kv_seq`` shard and combines the softmax by all-reduces, so its
    collective bytes a device come within ``COLLECTIVE_SLACK`` of the
    reference's (they were 190x while DTensor gathered the cache to write
    the row)."""
    mesh = "2x16x16" if multi_pod else "16x16"
    name = dryrun.cell_name("smollm-135m", "decode_32k", multi_pod) + ".json"
    port = _artifact(cells, f"smollm/{mesh}", name)["hlo_cost"]
    ref = _artifact(cells, f"ref/{mesh}", name)["hlo_cost"]
    got, want = port["total_collective_bytes_per_device"], ref["total_collective_bytes_per_device"]
    assert 0 < got <= COLLECTIVE_SLACK * want, (port["collective_bytes_per_device"],
                                                ref["collective_bytes_per_device"])


def test_the_cli_refuses_a_second_world():
    """A process already in a world cannot make the fake one: the dry run
    says so rather than trace on the wrong world."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            with dryrun.fake_world(256):
                pass
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-0.6b"], ids=["smollm", "qwen3"])
def test_train_memory_is_laid_out_as_the_references(cells, arch):
    """smollm-135m and qwen3-0.6b train_4k on (16, 16), whose head moves
    the logits from the vocab split to the sequence split (Megatron-SP):
    the move is one all-to-all of each rank's shards (DTensor gathered the
    whole vocab for it on a mesh of CPU ranks, three (16, 4096, vocab)
    buffers a device), so the temp, which leaves the step's outputs out as
    XLA's does, lies within ``TEMP_SLACK`` of the reference's (4.94x and
    5.24x before); the FLOPs a device are the reference's, exactly; and
    no storage alive at the temp's peak holds a rank's rows over the whole
    sequence with the vocab whole."""
    key = {"smollm-135m": "smollm-train", "qwen3-0.6b": "qwen3-train"}[arch]
    name = dryrun.cell_name(arch, "train_4k", False) + ".json"
    port = _artifact(cells, f"{key}/16x16", name)
    ref = _artifact(cells, f"ref/{key}/16x16", name)
    temp = port["memory_analysis"]["temp_size_in_bytes"]
    want = ref["memory_analysis"]["temp_size_in_bytes"]
    assert 0 < temp <= TEMP_SLACK * want, (temp, want, port["layout"]["temp_at_peak"])
    assert temp <= port["memory_analysis"]["traced_peak_in_bytes"]
    assert port["hlo_cost"]["flops_per_device"] == ref["hlo_cost"]["flops_per_device"]
    assert port["hlo_cost"]["collective_bytes_per_device"].get("all-to-all", 0) > 0
    vocab, seq = get_bundle(arch).model.vocab_size, port["seq_len"]
    at_peak = port["layout"]["temp_at_peak"]
    assert at_peak and not [a for a in at_peak if a["shape"][-1:] == [vocab]
                            and seq in a["shape"][:-1]], at_peak
