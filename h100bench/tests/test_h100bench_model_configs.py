"""A model configuration enters the benchmark as new files: its checks by
kind and the sizing floors (``harness/configs.py``), and the benchmark's
own count of a decoder's forward work (``harness/model_work.py``)."""

import copy
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench.harness import bench, configs, guard
from h100bench.harness import model_work as mw
from h100bench.harness import roofline
from test_h100bench_files import (config_entry_ok, four_chip_cells_ok,
                                  top_level_ok)

HERE = Path(__file__).resolve().parent
SAMPLE_PATH = HERE / "data" / "model-sample.glm4-9b.json"
SAMPLE = json.loads(SAMPLE_PATH.read_text())
GLM = SAMPLE["widths"]
# deepseek-moe-16b as the registry has it, every layer whole on one
# chip: all 64 routed experts and the whole vocabulary.
MOE = {
    "name": "model-sample.deepseek-moe-16b", "arch": "deepseek-moe-16b",
    "source": "https://huggingface.co/deepseek-ai/deepseek-moe-16b-base",
    "source_part": "config.json: num_hidden_layers 28, hidden_size 2048, "
                   "num_attention_heads 16, num_key_value_heads 16 (head "
                   "dim 128), moe_intermediate_size 1408, n_routed_experts "
                   "64, num_experts_per_tok 6, n_shared_experts 2, "
                   "vocab_size 102400",
    "dtype": "bfloat16",
    "deployment": {"chips_per_layer": 1,
                   "division": "every layer whole on one chip"},
    "widths": {"n_layers": 28, "d_model": 2048, "n_heads": 16,
               "n_kv_heads": 16, "head_dim": 128, "d_ff": 1408,
               "vocab_size": 102400, "n_experts": 64, "top_k": 6,
               "n_shared_experts": 2, "moe_d_ff": 1408},
    "reduced": {}, "assumed": {},
    "guarantees": ["greedy tokens within the limit"],
}


def test_sample_passes_and_builds_the_program_config():
    assert configs.kind(SAMPLE) == "model"
    configs.check(SAMPLE)
    cfg = configs.arch_config(SAMPLE)
    assert (cfg.name, cfg.n_layers, cfg.d_model, cfg.n_kv_heads,
            cfg.d_ff) == ("glm4-9b", 40, 4096, 2, 13696)


def test_moe_sample_passes_with_every_expert():
    configs.check(MOE)
    cfg = configs.arch_config(MOE)
    assert (cfg.n_experts, cfg.top_k, cfg.vocab_size) == (64, 6, 102400)


def test_usec_files_are_usec():
    for c in bench.benchmark()["configs"]:
        data = json.loads((bench.ROOT / c["file"]).read_text())
        assert configs.kind(data) == "usec"


def _set(path, value, base=SAMPLE):
    """A copy of ``base`` with ``path`` (keys joined by '.') set to
    ``value``, or deleted where ``value`` is ``...``."""
    data = copy.deepcopy(base)
    *outer, last = path.split(".")
    node = data
    for k in outer:
        node = node[k]
    if value is ...:
        del node[last]
    else:
        node[last] = value
    return data


def _cut(key, held, published, base=SAMPLE, **extra):
    data = _set(f"widths.{key}", held, base)
    data["reduced"] = dict(data["reduced"],
                           **{key: {"source": published, "why": "cut"}})
    for path, value in extra.items():
        data = _set(path.replace("__", "."), value, data)
    return data


def test_one_chips_share_of_heads_and_vocabulary_passes():
    """Each layer divided over 2 chips: half the query and K/V heads and
    half the vocabulary here."""
    data = _set("deployment.chips_per_layer", 2)
    for key, held, published in (("n_heads", 16, 32), ("n_kv_heads", 1, 2),
                                 ("vocab_size", 75776, 151552)):
        data = _cut(key, held, published, data)
    configs.check(data)
    cfg = configs.arch_config(data)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size) == \
        (16, 1, 128, 75776)


MUTATIONS = {
    "d_model_cut": (_cut("d_model", 2048, 4096), "reduced.d_model"),
    "d_model_cut_unlisted": (_set("widths.d_model", 2048),
                             "widths.d_model"),
    "head_dim_missing": (_set("widths.head_dim", ...), "widths.head_dim"),
    "reduced_without_source": (
        _set("reduced.n_layers", {"why": "shallower"},
             _set("widths.n_layers", 20)), "reduced.n_layers"),
    "three_layers": (_cut("n_layers", 3, 40), "widths.n_layers"),
    "four_experts_of_64": (
        _cut("n_experts", 4, 64, MOE, deployment__chips_per_layer=16),
        "reduced.n_experts"),
    # The router would be built 8 wide, top-6 of 8: not the deployment.
    "one_chips_share_of_experts": (
        _cut("n_experts", 8, 64, MOE, deployment__chips_per_layer=8),
        "reduced.n_experts"),
    "leading_dense_layer": (_set("leading_dense", 1, MOE), "leading_dense"),
    "unlisted_number_not_in_the_source": (_set("widths.d_ff", 13697),
                                          "widths.d_ff"),
    "cut_source_not_in_the_source": (_cut("n_layers", 20, 48),
                                     "reduced.n_layers"),
    "vocabulary_under_an_eighth": (_cut("vocab_size", 18000, 151552),
                                   "widths.vocab_size"),
    "heads_not_a_chips_share": (
        _cut("n_heads", 16, 32, deployment__chips_per_layer=4),
        "reduced.n_heads"),
    "unknown_arch": (_set("arch", "glm5-744b"), "arch"),
    "widths_key_not_a_field": (_set("widths.hidden_size", 4096),
                               "widths.hidden_size"),
    "moe_key_missing": (_set("widths.moe_d_ff", ..., MOE),
                        "widths.moe_d_ff"),
    "no_chips_per_layer": (_set("deployment.chips_per_layer", 0),
                           "deployment.chips_per_layer"),
    "float16": (_set("dtype", "float16"), "dtype"),
    "no_guarantees": (_set("guarantees", []), "guarantees"),
    "neither_placement_nor_arch": (_set("arch", ...), None),
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_each_mutation_fails_naming_its_key(case):
    data, key = MUTATIONS[case]
    named = f"^{re.escape(key)}:" if key else "'placement'.*'arch'"
    with pytest.raises(ValueError, match=named):
        configs.check(data)


def test_neither_kind_names_both_keys():
    with pytest.raises(ValueError, match="'placement'.*'arch'"):
        configs.kind({"name": "x"})


def test_usec_tiles_must_divide_into_blocks():
    c = bench.benchmark()["configs"][0]
    data = json.loads((bench.ROOT / c["file"]).read_text())
    with pytest.raises(ValueError, match="^matrix_size"):
        configs.check(dict(data, matrix_size=36010))


def test_a_model_config_passes_every_file_check_as_new_files(tmp_path):
    """Today's BENCHMARK.json plus the sample as a configuration, in a
    checkout of its own: the file checks pass with no existing file of
    the benchmark edited."""
    b = bench.benchmark()
    b["configs"].append({
        "name": SAMPLE["name"], "source": SAMPLE["source"],
        "file": f"h100bench/configs/{SAMPLE['name']}.json", "reduced": [],
        "why": "a model configuration beside the USEC ones"})
    shutil.copytree(bench.HERE / "configs", tmp_path / "h100bench" / "configs")
    shutil.copy(SAMPLE_PATH, tmp_path / b["configs"][-1]["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b, indent=1))

    b = bench.benchmark(tmp_path)
    top_level_ok(b)
    four_chip_cells_ok(b)
    for cfg in b["configs"]:
        config_entry_ok(cfg, tmp_path)
    for w in b["workloads"]:
        assert bench.cell(w["name"], b, tmp_path).chips == 1


@pytest.mark.parametrize("cells,fours,ok", [
    (4, 1, True), (4, 2, False), (8, 2, True), (8, 3, False), (1, 1, True)])
def test_four_chip_cap(cells, fours, ok):
    b = {"workloads": [{"name": f"c{i}", "chips": 4 if i < fours else 1}
                       for i in range(cells)]}
    if ok:
        four_chip_cells_ok(b)
    else:
        with pytest.raises(AssertionError):
            four_chip_cells_ok(b)


# GLM-4-9B's layer: Q and O 4096 x 4096, K and V 4096 x 256, SwiGLU
# 3 x 4096 x 13696.
GLM_LAYER_PARAMS = 2 * 4096 * 4096 + 2 * 4096 * 256 + 3 * 4096 * 13696


def test_glm4_9b_prefill_8k_hand_count():
    assert GLM_LAYER_PARAMS == 203_948_032
    parts = mw.forward_parts(GLM, 8192, 8192, 1)
    matmuls = parts["projections"][0] + parts["ffn"][0]
    assert matmuls == pytest.approx(2 * 40 * GLM_LAYER_PARAMS * 8192,
                                    rel=1e-9)
    assert matmuls / 1e12 == pytest.approx(133.659382, abs=5e-7)
    # 8192 * 8193 / 2 causal pairs a head, 4 * 128 flops a pair, 32 heads.
    layer = 4 * 128 * 32 * 8192 * 8193 // 2
    assert layer == 549_822_922_752
    assert parts["attention"][0] == pytest.approx(40 * layer, rel=1e-9)
    assert parts["attention"][0] / 1e12 == pytest.approx(21.992917, abs=5e-7)
    ms, by = roofline.bound_ms(0, layer, roofline.BF16_FLOPS_PER_S)
    assert (round(ms, 5), round(ms, 4), by) == (0.55594, 0.5559,
                                                "operations")
    assert parts["head"][0] == pytest.approx(2 * 4096 * 151552, rel=1e-9)
    assert parts["head"][0] / 1e9 == pytest.approx(1.2415, abs=5e-5)
    flops, n_bytes = mw.forward_work(GLM, 8192, 8192, 1)
    assert flops / 1e12 == pytest.approx(155.653541, abs=5e-7)
    ms, by = roofline.bound_ms(n_bytes, flops, roofline.BF16_FLOPS_PER_S)
    assert (round(ms, 3), by) == (157.385, "operations")


def test_windowed_layer_hand_count():
    """recurrentgemma-2b's local attention layer: 10 heads of 256, a 2048
    window, 8192 tokens."""
    pairs = mw.causal_pairs(8192, 8192, 2048)
    assert pairs == 2048 * 2049 // 2 + (8192 - 2048) * 2048 == 14_681_088
    flops = 4 * 256 * 10 * pairs
    assert flops == pytest.approx(150.334e9, rel=3e-6)
    ms, by = roofline.bound_ms(0, flops, roofline.BF16_FLOPS_PER_S)
    assert (round(ms, 5), round(ms, 4), by) == (0.15201, 0.152,
                                                "operations")
    widths = dict(GLM, n_layers=2, n_heads=10, n_kv_heads=1, head_dim=256,
                  layer_pattern=["attn", "lattn"], window=2048)
    whole = 8192 * 8193 // 2
    assert mw.forward_parts(widths, 8192, 8192, 1)["attention"][0] == \
        pytest.approx(4 * 256 * 10 * (whole + pairs), rel=1e-9)


def test_glm4_9b_decode_token_hand_count():
    """One token at a context of 8192, its logits computed."""
    flops, n_bytes = mw.forward_work(GLM, 1, 8192, 1)
    assert flops == pytest.approx(
        2 * 40 * GLM_LAYER_PARAMS + 4 * 128 * 32 * 8192 * 40
        + 2 * 4096 * 151552, rel=1e-9)
    kv_row = 2 * 2 * 128                      # K and V of 2 heads of 128
    assert n_bytes == pytest.approx(2 * (
        40 * GLM_LAYER_PARAMS                 # the layers' weights
        + (2 * 40 + 1) * 4096                 # the norms
        + 4096                                # the token's embedding row
        + 4096 * 151552                       # the LM head
        + 40 * kv_row * 8192                  # the cache read
        + 40 * kv_row), rel=1e-9)             # the token's K/V written
    assert n_bytes == 17_893_613_568
    assert roofline.bound_ms(n_bytes, flops,
                             roofline.BF16_FLOPS_PER_S)[1] == "bytes"


def test_moe_hand_count():
    """deepseek-moe-16b's MoE FFN: a 64-wide router, 6 routed and 2
    shared experts a token; bytes the router and those 8 experts, the
    least any routing reads."""
    expert = 3 * 2048 * 1408
    layer = 2048 * 64 + expert * 8
    for tokens in (1, 8192):
        flops, n_bytes = mw.forward_parts(MOE["widths"], tokens, tokens,
                                          0)["ffn"]
        assert flops == pytest.approx(28 * 2 * tokens * layer, rel=1e-9)
        assert n_bytes == pytest.approx(2 * 28 * layer, rel=1e-9)


def test_causal_pairs_against_a_loop():
    for tokens, context in ((1, 1), (1, 9), (5, 9), (9, 9), (3, 40)):
        for window in (None, 1, 2, 5, 9, 64):
            q = range(context - tokens, context)
            want = sum(p - max(0, p - window + 1) + 1 if window else p + 1
                       for p in q)
            assert mw.causal_pairs(tokens, context, window) == want


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-370m",
                                  "internvl2-2b", "hubert-xlarge"])
def test_layers_without_a_count_raise(arch):
    import dataclasses

    from repro_torch.configs import get_config

    widths = dataclasses.asdict(get_config(arch))
    with pytest.raises(NotImplementedError):
        mw.forward_work(widths, 8, 8, 1)


def test_configs_and_count_load_no_jax():
    root = bench.ROOT
    code = f"""
import json, sys
sys.path[:0] = [{str(root / 'src')!r}, {str(root)!r}]
from h100bench.harness import configs, model_work
data = json.load(open({str(SAMPLE_PATH)!r}))
configs.check(data)
model_work.forward_work(data["widths"], 8, 8, 1)
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.configs" in mods
    assert guard.forbidden_loaded(dict.fromkeys(mods)) == []
