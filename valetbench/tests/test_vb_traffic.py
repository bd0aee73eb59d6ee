"""The traffic generator: seeds, ranges, pools, phases."""
import numpy as np
import pytest

from valetbench.harness.spec import HERE, load_json
from valetbench.harness.traffic import GRID, Traffic, log_grid


def spec(name):
    return load_json(HERE / "traffic" / f"{name}.json")


def draw(t, n):
    return [t.next_request() for _ in range(n)]


@pytest.mark.parametrize("name", ["chat.pressure", "long.pressure", "chat.roomy"])
def test_same_seed_same_requests(name):
    a = draw(Traffic(spec(name), 2 ** 31 + 11, 49155), 50)
    b = draw(Traffic(spec(name), 2 ** 31 + 11, 49155), 50)
    assert [len(r.prompt) for r in a] == [len(r.prompt) for r in b]
    assert [r.max_new for r in a] == [r.max_new for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["chat.pressure", "long.pressure"])
def test_lengths_in_range_and_the_same_sizes_in_the_same_order_for_every_seed(name):
    s = spec(name)
    g = GRID
    sizes = []
    for seed in (1, 2, 2 ** 40 + 3):
        reqs = draw(Traffic(s, seed, 32001), g)
        p = sorted(len(r.prompt) for r in reqs)
        o = sorted(r.max_new for r in reqs)
        assert s["prompt"]["min"] <= p[0] and p[-1] <= s["prompt"]["max"]
        assert s["output"]["min"] <= o[0] and o[-1] <= s["output"]["max"]
        assert all(r.prompt.min() >= 2 and r.prompt.max() < 32001 for r in reqs)
        sizes.append((p, o))
    assert sizes[0] == sizes[1] == sizes[2]
    a, b = draw(Traffic(s, 1, 32001), 70), draw(Traffic(s, 2, 32001), 70)
    assert [(len(x.prompt), x.max_new) for x in a] == [(len(x.prompt), x.max_new) for x in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    # a fresh pairing every grid's worth of requests
    assert [x.max_new for x in a[:6]] != [x.max_new for x in a[64:70]]


def test_log_grid_mean_is_the_log_uniform_mean():
    g = log_grid(128, 2048, 1024)
    assert abs(g.mean() - (2048 - 128) / np.log(16)) < 1.0


@pytest.mark.parametrize("name, pages", [("chat.pressure", 2400),
                                         ("long.pressure", 6083),
                                         ("chat.roomy", 9280)])
def test_pool_sizes(name, pages):
    assert Traffic(spec(name), 0, 100).pool_slots() == pages
