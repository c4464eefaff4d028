"""``BENCHMARK.json`` keeps to the contract's shapes, and every name in it is
found by name under ``perfbench/``; adding a mix needs only new files."""
import json
import re
import shutil

import pytest

from perfbench.harness import spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|per_tok")


@pytest.fixture(scope="module")
def bench():
    return spec.Spec().bench


def test_keys_and_names(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    things = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    names = [t["name"] for t in things]
    assert len(names) == len(set(names))
    for t in things:
        assert NAME.match(t["name"]), t["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


def test_bounds(bench):
    names = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in names
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_everything_is_found_by_name(bench):
    s = spec.Spec()
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")
        conf = s.config(c["name"])
        assert conf["source"] == c["source"] and conf["name"] == c["name"]
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
    for w in bench["workloads"]:
        s.config(w["config"])
        s.traffic(w["traffic"])
        settings = s.cell_settings(w["name"])
        assert settings["max_batch"] >= 1 and settings["check"]["mean_gap_limit"] > 0
        assert settings["check"].get("logit_gap_limit", 1) > 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(s.reader(m["name"]).read)


def test_cells_report_what_their_metrics_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    reports = {c: {m["name"] for m in bench["end_to_end"] if c in m.get("workloads", cells)}
               for c in cells}
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        layers.setdefault(m["layer"], m["layer"])
        for c in m.get("workloads", cells):
            assert c in cells and m["moves"] in reports[c], (m["name"], c)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_agree_with_their_published_sizes():
    s = spec.Spec()
    ds = json.loads((spec.ROOT / "perfbench/configs/deepseek-coder-33b.json").read_text())
    c, m = ds["config"], ds["model"]
    assert (m["d_model"], m["d_ff"], m["n_layers"], m["vocab"], m["norm_eps"]) == (
        c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"], c["vocab_size"],
        c["rms_norm_eps"])
    assert (m["attn"]["n_heads"], m["attn"]["n_kv_heads"], m["attn"]["rope_theta"]) == (
        c["num_attention_heads"], c["num_key_value_heads"], c["rope_theta"])
    nm = s.config("nemotron-4-15b")
    c, m = nm["config"], nm["model"]
    assert (m["d_model"], m["d_ff"], m["n_layers"], m["vocab"]) == (
        c["hidden_dimension"], c["ffn_hidden_size"], c["num_transformer_layers"],
        c["vocabulary_size"])
    assert (m["attn"]["n_heads"], m["attn"]["n_kv_heads"]) == (
        c["num_attention_heads"], c["num_kv_heads"])


def test_a_new_mix_needs_only_new_files(tmp_path):
    """A throwaway traffic file and a cell naming it, in a copy of the
    benchmark: the harness resolves both by name, and no file changed."""
    root = spec.ROOT
    shutil.copytree(root / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "nemotron15b.burst", "config": "nemotron-4-15b",
                               "traffic": "burst", "chips": 1, "why": "a throwaway mix"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench" / "traffic" / "burst.json").write_text(json.dumps({
        "loop": "closed", "pair_seed": 1,
        "prompt_len": {"dist": "uniform", "min": 4, "max": 9},
        "output_len": {"dist": "uniform", "min": 2, "max": 3}}))
    (tmp_path / "perfbench" / "cells" / "nemotron15b.burst.json").write_text(json.dumps(
        {"max_batch": 2, "check": {"tokens": 10, "max_requests": 2, "min_tokens": 1,
                                   "logit_gap_limit": 1.0, "mean_gap_limit": 1.0}}))
    (tmp_path / "perfbench" / "metrics" / "rounds.py").write_text(
        "def read(run):\n    return len(run.window.rounds)\n")
    s = spec.Spec(tmp_path)
    cell = s.cell("nemotron15b.burst")
    reqs = traffic.Stream(s.traffic(cell["traffic"]), 100, 7, 2).take(8)
    assert sorted(len(r.prompt) for r in reqs)[0] >= 4
    assert s.cell_settings("nemotron15b.burst")["max_batch"] == 2
    assert s.reader("rounds").read(type("R", (), {"window": type("W", (), {"rounds": [1]})})) == 1
    for path in (root / "perfbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            copy = tmp_path / path.relative_to(root)
            assert copy.read_bytes() == path.read_bytes(), path
