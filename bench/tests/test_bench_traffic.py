"""The traffic generator: one seed draws the same groups, another draws
other ids and orders over the same sizes."""
import collections
import json
import pathlib
import sys

import numpy as np
import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness.traffic import Traffic, padded, stratified_lengths  # noqa: E402

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
SEED = 2**31 + 17


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def lengths(traffic, first, n):
    return sorted(len(r.prompt) for i in range(first, first + n)
                  for r in traffic.group(i))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_groups(name):
    a, b = Traffic(mix(name), 1000, SEED), Traffic(mix(name), 1000, SEED)
    for i in (0, 1, 9):
        for x, y in zip(a.group(i), b.group(i)):
            assert x.uid == y.uid and np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_other_ids_same_sizes(name):
    spec = mix(name)
    a, b = Traffic(spec, 1000, SEED), Traffic(spec, 1000, SEED + 1)
    assert any(not np.array_equal(x.prompt[:8], y.prompt[:8])
               for x, y in zip(a.group(0), b.group(0)))
    g = int(spec["block_groups"])
    for i in range(2 * g + 1):
        assert lengths(a, i, 1) == lengths(b, i, 1)
    assert lengths(a, 0, g) == sorted(
        stratified_lengths(spec["prompt_len"], g * spec["batch"]))


@pytest.mark.parametrize("name", MIXES)
def test_first_group_holds_the_longest_prompt(name):
    t = Traffic(mix(name), 1000, SEED)
    longest = max(max(g) for g in t.layout)
    assert max(len(r.prompt) for r in t.group(0)) == longest
    assert {len(r.prompt) for r in t.warmup_group()} == {longest}
    assert all(len(r.prompt) + r.new_tokens <= t.max_len
               for r in t.group(0))


def test_log_uniform_quantiles_and_padding():
    got = stratified_lengths({"dist": "log_uniform", "lo": 256, "hi": 1024},
                             4)
    assert got == [round(256 * 4 ** ((i + 0.5) / 4)) for i in range(4)]
    t = Traffic(mix("long_prompt"), 1000, SEED)
    grp = t.group(3)
    toks = padded(grp)
    s = toks.shape[1]
    for row, r in zip(toks, grp):
        assert (row[:s - len(r.prompt)] == 0).all()
        assert np.array_equal(row[s - len(r.prompt):], r.prompt)
    assert collections.Counter(r.new_tokens for r in grp) == {4: 4}
