"""The port's tuning config: the ported knobs have the reference's names and
defaults, `override` nests and restores, `set_tuning` installs and clears,
and the environment is read like the reference reads it."""

import dataclasses

import pytest

from tfhe_tpu import tuning as j_tuning
from tfhe_tpu_torch import tuning as p_tuning

PORTED = ("karatsuba_depth", "bs_bake_budget", "mk_bake_budget",
          "mk_sparse_limbs", "mk_cmux", "mk_chunk", "mk_mega", "mk_compact",
          "mk_progressive")


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in p_tuning._ENV.values():
        monkeypatch.delenv(var, raising=False)
    p_tuning.set_tuning(None)
    yield
    p_tuning.set_tuning(None)


@pytest.mark.parametrize("name", PORTED)
def test_defaults_equal_reference(name):
    ref = {f.name: f for f in dataclasses.fields(j_tuning.TuningConfig)}
    got = {f.name: f for f in dataclasses.fields(p_tuning.TuningConfig)}
    assert set(got) == set(PORTED)
    assert got[name].default == ref[name].default
    assert got[name].type == ref[name].type
    assert p_tuning._ENV[name] == j_tuning._ENV[name]
    assert getattr(p_tuning.get_tuning(), name) == \
        getattr(j_tuning.TuningConfig(), name)


def test_override_nests_and_restores():
    base = p_tuning.get_tuning()
    with p_tuning.override(bs_bake_budget=0) as outer:
        assert outer.bs_bake_budget == 0
        assert p_tuning.get_tuning().karatsuba_depth == base.karatsuba_depth
        with p_tuning.override(karatsuba_depth=0):
            cfg = p_tuning.get_tuning()
            assert (cfg.karatsuba_depth, cfg.bs_bake_budget) == (0, 0)
        assert p_tuning.get_tuning() == outer
    assert p_tuning.get_tuning() == base


def test_override_restores_after_an_exception():
    base = p_tuning.get_tuning()
    with pytest.raises(RuntimeError):
        with p_tuning.override(karatsuba_depth=1):
            raise RuntimeError("boom")
    assert p_tuning.get_tuning() == base


def test_override_rejects_an_unported_knob():
    with pytest.raises(TypeError):
        with p_tuning.override(btk=64):
            pass


def test_set_tuning_installs_and_clears():
    p_tuning.set_tuning(p_tuning.TuningConfig(karatsuba_depth=1))
    assert p_tuning.get_tuning().karatsuba_depth == 1
    p_tuning.set_tuning(None)
    assert p_tuning.get_tuning() == p_tuning.TuningConfig()


def test_environment_is_read_per_call(monkeypatch):
    monkeypatch.setenv("TFHE_TPU_BS_BAKE_BUDGET", "0")
    monkeypatch.setenv("TFHE_TPU_KARATSUBA_DEPTH", "1")
    assert p_tuning.get_tuning() == p_tuning.TuningConfig(1, 0)
    ref = j_tuning.from_env()
    assert (ref.karatsuba_depth, ref.bs_bake_budget) == (1, 0)
    with p_tuning.override(bs_bake_budget=-1):  # an override beats the env
        assert p_tuning.get_tuning().bs_bake_budget == -1


@pytest.mark.parametrize("raw,want", [("0", False), ("off", False),
                                      ("", False), ("1", True),
                                      ("Yes", True)])
def test_environment_booleans_parse_like_the_reference(monkeypatch, raw, want):
    monkeypatch.setenv("TFHE_TPU_MK_PROGRESSIVE", raw)
    monkeypatch.setenv("TFHE_TPU_MK_CMUX", "expand")
    monkeypatch.setenv("TFHE_TPU_MK_CHUNK", "4")
    got, ref = p_tuning.get_tuning(), j_tuning.from_env()
    assert got.mk_progressive is want and ref.mk_progressive is want
    assert (got.mk_cmux, got.mk_chunk) == (ref.mk_cmux, ref.mk_chunk) \
        == ("expand", 4)


def test_environment_rejects_a_bad_boolean(monkeypatch):
    monkeypatch.setenv("TFHE_TPU_MK_PROGRESSIVE", "maybe")
    with pytest.raises(ValueError, match="expected a boolean"):
        p_tuning.get_tuning()
