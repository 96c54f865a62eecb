"""The traffic generator: a seed gives the same schedule every time, and
every seed offers the same work in another order."""

import numpy as np
import pytest

from benchmark import traffic_gen
from benchmark.drivers import open_loop, sessions

CHAT = {"kind": "open_loop", "rate_per_s": 5.0,
        "prompt_tokens": {"dist": "lognormal", "median": 1024, "sigma": 0.7,
                          "min": 128, "max": 3072},
        "output_tokens": {"dist": "lognormal", "median": 128, "sigma": 0.85,
                          "min": 16, "max": 1024},
        "after_window_s": 10, "schedule_seed": 1}


class _Cfg:
    vocab_size = 64000


CELL = {"engine": {"max_len": 4096}}


def test_a_seed_repeats_its_schedule():
    a = open_loop.plan(CHAT, CELL, _Cfg, 40, 2 ** 31 + 77)
    b = open_loop.plan(CHAT, CELL, _Cfg, 40, 2 ** 31 + 77)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.max_new, b.max_new)
    assert all(np.array_equal(x, y) for x, y in zip(a.prompts, b.prompts))


def test_every_seed_replays_the_schedule_with_other_tokens():
    a = open_loop.plan(CHAT, CELL, _Cfg, 40, 1)
    b = open_loop.plan(CHAT, CELL, _Cfg, 40, 2)
    assert np.array_equal(a.offsets, b.offsets)
    assert np.array_equal(a.max_new, b.max_new)
    assert [len(p) for p in a.prompts] == [len(p) for p in b.prompts]
    assert not all(np.array_equal(x, y) for x, y in zip(a.prompts,
                                                         b.prompts))


def test_the_schedule_holds_its_work_and_its_window():
    a = open_loop.plan(CHAT, CELL, _Cfg, 40, 1)
    other = open_loop.plan(dict(CHAT, schedule_seed=2), CELL, _Cfg, 40, 1)
    assert a.window == other.window == slice(0, 200)
    # Another schedule seed: the same gaps and lengths in another order.
    for x, y in ((np.diff(a.offsets[:200]), np.diff(other.offsets[:200])),
                 (a.max_new, other.max_new),
                 ([len(p) for p in a.prompts],
                  [len(p) for p in other.prompts])):
        assert sorted(x) == pytest.approx(sorted(y))
        assert list(x) != list(y)
    # Every window request is due inside the window, the rest after it.
    assert a.offsets[199] < 40 <= a.offsets[200]


def test_the_preroll_comes_before_the_window():
    a = open_loop.plan(dict(CHAT, preroll_s=15), CELL, _Cfg, 40, 3)
    # 75 arrivals in the 15 s before the window, 200 in it, 50 after it.
    assert a.window == slice(75, 275) and len(a.offsets) == 325
    pre, win, after = (a.offsets[:75], a.offsets[75:275], a.offsets[275:])
    assert pre[0] == -15 and np.all(pre < 0) and np.all(np.diff(a.offsets) > 0)
    assert win[0] == 0 and win[-1] < 40 <= after[0]
    # The window holds the same work with or without a pre-roll.
    b = open_loop.plan(CHAT, CELL, _Cfg, 40, 3)
    assert sorted(np.diff(win)) == pytest.approx(sorted(np.diff(b.offsets[:200])))
    assert sorted(a.max_new[75:275]) == sorted(b.max_new[:200])


def test_lengths_stay_in_bounds_and_follow_the_median():
    rng = traffic_gen.rng_for(5)
    lens = traffic_gen.lengths(CHAT["prompt_tokens"], 1001, rng)
    assert lens.min() >= 128 and lens.max() <= 3072
    assert np.median(lens) == 1024
    u = traffic_gen.lengths({"dist": "uniform", "min": 3072, "max": 5120},
                            48, rng)
    assert u.min() >= 3072 and u.max() <= 5120


def test_poisson_gaps_have_the_rate():
    off = traffic_gen.poisson_offsets(5.0, 2001, traffic_gen.rng_for(0))
    assert off[0] == 0.0 and np.all(np.diff(off) > 0)
    assert np.mean(np.diff(off)) == pytest.approx(0.2, rel=0.01)


def test_sessions_decode_to_max_len():
    mix = {"kind": "sessions", "sessions": 48,
           "prompt_tokens": {"dist": "uniform", "min": 3072, "max": 5120}}
    p = sessions.plan(mix, {"engine": {"max_len": 8192}}, _Cfg, 40, 9)
    assert len(p.prompts) == 48
    assert all(len(x) + int(m) == 8192 for x, m in zip(p.prompts, p.max_new))
