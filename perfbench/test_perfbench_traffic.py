"""The traffic generator: the same requests for the same seed, and every
seed, and every round of a closed loop, the same sizes in another order."""
from collections import Counter

import numpy as np
import pytest

from perfbench.harness import spec, traffic

MIXES = ["chat", "complete"]
BIG_SEED = 2 ** 31 + 12345


CLIENTS = 8


def take(mix, seed, n, vocab=1000, clients=CLIENTS):
    return traffic.Stream(spec.Spec().traffic(mix), vocab, seed, clients).take(n)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    a, b = take(mix, BIG_SEED, 100), take(mix, BIG_SEED, 100)
    assert [(r.max_new, r.prompt.tolist()) for r in a] == [(r.max_new, r.prompt.tolist()) for r in b]
    c = take(mix, BIG_SEED + 1, 100)
    assert [r.prompt.tolist() for r in a] != [r.prompt.tolist() for r in c]


@pytest.mark.parametrize("clients", [8, 32])
@pytest.mark.parametrize("mix", MIXES)
def test_every_seed_serves_the_same_sizes(mix, clients):
    """Each round (a block of one request a client) holds the same sizes,
    whatever the seed; only their order moves."""
    rounds = [take(mix, s, 3 * clients, clients=clients) for s in (1, 99, BIG_SEED)]
    blocks = [Counter((len(r.prompt), r.max_new) for r in reqs[k:k + clients])
              for reqs in rounds for k in range(0, 3 * clients, clients)]
    assert all(b == blocks[0] for b in blocks)
    orders = [[len(r.prompt) for r in reqs[:clients]] for reqs in rounds]
    assert orders[0] != orders[1]


@pytest.mark.parametrize("mix", MIXES)
def test_sizes_keep_to_the_mix(mix):
    m = spec.Spec().traffic(mix)
    reqs = take(mix, 5, 64, vocab=37, clients=64)
    p = np.array([len(r.prompt) for r in reqs])
    o = np.array([r.max_new for r in reqs])
    assert p.min() >= m["prompt_len"]["min"] and p.max() <= m["prompt_len"]["max"]
    assert o.min() >= m["output_len"]["min"] and o.max() <= m["output_len"]["max"]
    assert all(0 <= r.prompt.min() and r.prompt.max() < 37 for r in reqs)
    assert "arXiv" in m["source"] and m["assumed"]
    for dist, xs in ((m["prompt_len"], p), (m["output_len"], o)):
        mid = dist.get("median", (dist["min"] + dist["max"]) / 2)
        assert abs(np.median(xs) - mid) <= 0.03 * mid + 1


def test_quantiles():
    logn = {"dist": "lognormal", "median": 96, "sigma": 0.6, "min": 32, "max": 256}
    assert traffic.quantile(logn, 0.5) == 96
    assert traffic.quantile(logn, 0.001) == 32 and traffic.quantile(logn, 0.999) == 256
    uni = {"dist": "uniform", "min": 8, "max": 32}
    assert [traffic.quantile(uni, u) for u in (0.0, 0.5, 0.9999)] == [8, 20, 32]
    with pytest.raises(ValueError):
        traffic.quantile({"dist": "zipf", "min": 1, "max": 2}, 0.5)
