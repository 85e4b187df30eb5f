"""The traffic generator: the same seed gives the same inputs, another seed
other inputs of the same sizes, within the mix's ranges."""

import json

import pytest
import torch

from benchmark import generate, harness

MIXES = sorted(p.stem for p in (harness.HERE / "traffic").glob("*.json"))


def _mix(name):
    return json.loads((harness.HERE / "traffic" / f"{name}.json").read_text())


def _draw(mix, seed, index):
    if mix["kind"] == "schedules":
        small = dict(mix, games=64)
        return generate.schedule_table(small, seed, index, 400, "cpu")[0]
    small = dict(mix, games=64)
    x0, seeds = generate.closed_loop_starts(small, seed, index, "cpu")
    return torch.cat([x0, seeds[:, None].to(x0.dtype)], dim=1)


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_inputs(name):
    mix = _mix(name)
    big = 2 ** 31 + 12345
    assert torch.equal(_draw(mix, big, 3), _draw(mix, big, 3))


@pytest.mark.parametrize("name", MIXES)
def test_other_seed_or_index_other_inputs_same_sizes(name):
    mix = _mix(name)
    a, b, c = _draw(mix, 7, 0), _draw(mix, 8, 0), _draw(mix, 7, 1)
    assert a.shape == b.shape == c.shape
    assert not torch.equal(a, b) and not torch.equal(a, c)


def test_uniform_schedule_range_and_hold():
    mix = _mix("uniform_b32768")
    u, hold = generate.schedule_table(dict(mix, games=32), 5, 0, 400, "cpu")
    assert hold == 10 and u.shape == (32, 40, 4, 2)
    assert float(u.min()) >= -8.0 and float(u.max()) <= 8.0


def test_corner_schedule_one_corner_a_game():
    mix = _mix("corner_b32768")
    u, hold = generate.schedule_table(dict(mix, games=32), 5, 0, 400, "cpu")
    assert hold == 400 and u.shape == (32, 1, 4, 2)
    assert set(u.unique().tolist()) <= {-8.0, 8.0}
    assert torch.equal(u, u[:, :, :1].expand_as(u))   # all four players


def test_closed_loop_starts_ranges():
    mix = _mix("b512")
    x0, seeds = generate.closed_loop_starts(mix, 5, 0, "cpu")
    assert x0.shape == (512, 4) and seeds.shape == (512,)
    assert float(x0[:, 0].abs().max()) <= 1.0
    assert float(x0[:, 1].abs().max()) <= 0.5
    assert float(x0[:, 2:].abs().max()) <= 2.0
    assert int(seeds.min()) >= 1


def test_every_schedule_mix_names_a_family_file_and_an_unknown_one_raises():
    for name in MIXES:
        mix = _mix(name)
        if mix["kind"] == "schedules":
            assert (harness.HERE / "generators" /
                    f"{mix['family']}.py").is_file()
    with pytest.raises(ValueError):
        generate.schedule_table({"games": 4, "family": "no_such_family"}, 1,
                                0, 10, "cpu")
