"""``BENCHMARK.json`` and the files it names: every cell resolves to its
configuration, traffic mix, cell file and metric readers; the names,
units and bounds keep to the benchmark's rules; each configuration file
runs the port's registry widths, cut only where ``reduced`` says."""
import json
import re

import pytest

from perfkit import harness, manifest

M = manifest.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(x["name"] for x in M["end_to_end"] + M["per_layer"])) \
        == len(M["end_to_end"]) + len(M["per_layer"])
    assert all(UNIT.match(e["unit"]) for e in M["end_to_end"] +
               M["per_layer"])
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_bounds():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in e2e.values():
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_cell_resolves(w):
    c = manifest.cell(w)
    assert c["chips"] in (1, 4)
    assert c["sizing"]["batch_per_chip"] >= 1
    assert set(c["sizing"]["limits"]) >= {"loss_gap", "grad_gap",
                                          "change_gap"}
    if c["chips"] > 1:
        assert c["sizing"]["limits"]["rank_spread"] == 0
    assert {e["name"] for e in c["end_to_end"]} >= {"setup_s",
                                                     "tokens_per_s"}
    assert c["per_layer"]
    for e in c["per_layer"]:
        assert callable(manifest.metric_reader(e["name"]))
        assert e["moves"] in {x["name"] for x in c["end_to_end"]}


def test_config_and_traffic_pairs_once():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_mix_ranks_match_chips(tmp_path):
    for w in M["workloads"]:
        mix = manifest.load_json(manifest.BENCH / "traffic" /
                                 f"{w['traffic']}.json")
        assert mix["data_ranks"] == w["chips"], w["name"]
    one = next(w for w in M["workloads"] if w["chips"] == 1)
    four = next(w for w in M["workloads"] if w["chips"] == 4)
    bad = dict(M, workloads=[dict(one, traffic=four["traffic"])])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bad))
    for c in M["configs"]:
        (tmp_path / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / c["file"]).write_text(
            (manifest.ROOT / c["file"]).read_text())
    with pytest.raises(ValueError, match="data ranks"):
        manifest.cell(one["name"], root=tmp_path)


def test_four_chip_share():
    four = [w for w in M["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("entry", M["configs"], ids=lambda e: e["name"])
def test_config_matches_registry(entry):
    conf = manifest.load_json(manifest.ROOT / entry["file"])
    assert harness.registry_mismatch(conf) == []
    assert entry["reduced"] == ["num_hidden_layers"]
    assert conf["published"]["num_hidden_layers"] > conf["num_hidden_layers"]
    for key, d in conf["deviations"].items():
        assert d["why"] and isinstance(d["changes_flops_or_bytes"], bool), key
    cfg = harness.port_config(conf)
    theta = conf["deviations"]["rope_scaling"]["port_rope_theta"]
    assert cfg.rope_theta == theta
    if cfg.moe is not None:
        assert conf["deviations"]["capacity_factor"]["port"] == \
            cfg.moe.capacity_factor


def test_v2_lite_holds_its_published_groups():
    conf = manifest.load_json(manifest.BENCH / "configs" /
                              "deepseek-v2-lite-16b.l4.json")
    assert conf["rope_scaling"] == {
        "beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}
    assert conf["q_lora_rank"] is None
    assert (conf["norm_topk_prob"], conf["seq_aux"], conf["topk_method"],
            conf["scoring_func"], conf["routed_scaling_factor"],
            conf["rms_norm_eps"], conf["max_position_embeddings"]) == \
        (False, True, "greedy", "softmax", 1, 1e-6, 163840)
