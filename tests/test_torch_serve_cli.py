"""The port's serving CLI, ``repro_torch.launch.serve``, on the CPU.

``main([... "--reduced", "--device", "cpu"])`` serves the requests the
JAX launcher makes (the same flags, prompts drawn the same way from
``--seed``) through the port's `LMServer`; its tokens equal those of an
`LMServer` built with the same seed and served the same requests, and a
run as a module prints the completions and the stats.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.runtime.server import LMServer, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _requests(cfg, n, prompt_len, max_new, seed):
    """The launcher's requests, drawn as ``serve.main`` draws them."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(2, cfg.vocab, rng.integers(4, prompt_len + 1))
                    .tolist(), max_new=max_new) for i in range(n)]


@pytest.mark.parametrize("arch,max_batch", [("nemotron-4-15b", 4), ("deepseek-coder-33b", 3),
                                            ("qwen2.5-3b", 8)])
def test_main_gives_the_tokens_of_the_server(arch, max_batch, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests", "6",
            "--max-batch", str(max_batch), "--max-new", "5", "--prompt-len", "20",
            "--seed", "3"]
    srv, outs = serve.main(argv)
    assert srv.device.type == "cpu" and srv.max_batch == max_batch
    cfg = get_config(arch).reduced()
    want = LMServer(cfg, max_batch=max_batch, seed=3, device="cpu").serve(
        _requests(cfg, 6, 20, 5, 3))
    assert [o.tokens for o in outs] == [o.tokens for o in want]
    assert [o.prompt_len for o in outs] == [o.prompt_len for o in want]
    printed = capsys.readouterr().out
    assert "req 0:" in printed
    stats = json.loads(printed[printed.index("{"):])
    assert stats["requests"] == 6 and stats["rounds"] == -(-6 // max_batch)
    assert stats["decode_tokens"] == sum(len(o.tokens) for o in outs)


def test_main_defaults_to_the_card():
    """Without ``--device`` the launcher asks for the card, which the CPU
    sandbox lacks: the server refuses, as every entry point of the port."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would serve")
    with pytest.raises(RuntimeError):
        serve.main(["--arch", "tiny", "--reduced", "--requests", "1"])


def test_run_as_a_module():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "nemotron-4-15b", "--reduced", "--device", "cpu", "--requests", "2",
                          "--max-new", "3"], cwd=ROOT, env={**os.environ, "PYTHONPATH": "src"},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("req ") == 2 and '"decode_tokens": 6' in out.stdout
