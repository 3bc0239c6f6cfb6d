"""The port's Model carries the JAX Model across as data.

`write_model_npz` is the one writer of `trajoptkp_tpu_torch/models/*.npz`:
it dumps a JAX `Model` (from `load_mjcf` on the repo's XMLs) field by field.
Regenerate with

    JAX_PLATFORMS=cpu python -c "from tests.test_torch_model import \\
        write_all_models; write_all_models()"

The tests hold the checked-in files and `model_from_numpy` to `load_mjcf`
exactly (tolerance 0: the npz holds the same float64 values).
"""

import os

import jax
import numpy as np
import pytest
import torch

from trajoptkp_tpu.dynamics.mjcf import load_mjcf
from trajoptkp_tpu_torch.dynamics import model as pm

jax.config.update("jax_enable_x64", True)

XML_DIR = os.path.join(os.path.dirname(__file__), "..", "trajoptkp_tpu",
                       "models")
PORTED = ("acrobot", "pentabot")


def _npz_fields(jm) -> dict:
    out = {}
    for f in pm.INT_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.int64)
    for f in pm.INT_TUPLE_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.int64).reshape(-1)
    for f in pm.BOOL_TUPLE_FIELDS:
        out[f] = np.asarray(getattr(jm, f), bool).reshape(-1)
    for f in pm.NAME_FIELDS:
        out[f] = np.asarray(getattr(jm, f), dtype=np.str_).reshape(-1)
    out["contact_pairs"] = np.asarray(jm.contact_pairs, np.int64).reshape(-1, 2)
    out["integrator"] = np.asarray(jm.integrator, dtype=np.str_)
    out["source_xml"] = np.asarray(jm.source_xml or "", dtype=np.str_)
    for f in pm.ARRAY_FIELDS:
        out[f] = np.asarray(getattr(jm, f), np.float64)
    return out


def write_model_npz(jm, path: str) -> None:
    np.savez(path, **_npz_fields(jm))


def write_all_models() -> None:
    for name in PORTED:
        jm = load_mjcf(os.path.join(XML_DIR, f"{name}.xml"))
        write_model_npz(jm, os.path.join(pm.MODELS_DIR, f"{name}.npz"))


def _assert_model_equal(port, jm):
    for f in (pm.INT_FIELDS + pm.INT_TUPLE_FIELDS + pm.BOOL_TUPLE_FIELDS
              + pm.NAME_FIELDS + pm.STR_FIELDS):
        assert getattr(port, f) == getattr(jm, f), f
    assert port.contact_pairs == tuple(tuple(p) for p in jm.contact_pairs)
    for f in pm.ARRAY_FIELDS:
        got = getattr(port, f)
        assert got.dtype == torch.float64, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jm, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", PORTED)
def test_checked_in_npz_matches_load_mjcf(name):
    jm = load_mjcf(os.path.join(XML_DIR, f"{name}.xml"))
    port = pm.load_model(name, device="cpu")
    _assert_model_equal(port, jm)


@pytest.mark.parametrize("name", PORTED)
def test_model_from_numpy_matches_load_mjcf(name, tmp_path):
    jm = load_mjcf(os.path.join(XML_DIR, f"{name}.xml"))
    path = tmp_path / f"{name}.npz"
    write_model_npz(jm, str(path))
    with np.load(path) as z:
        port = pm.model_from_numpy(z, device="cpu")
    _assert_model_equal(port, jm)
    # the writer is deterministic: the checked-in file holds the same arrays
    with np.load(path) as fresh, \
            np.load(os.path.join(pm.MODELS_DIR, f"{name}.npz")) as kept:
        assert sorted(fresh.files) == sorted(kept.files)
        for f in fresh.files:
            np.testing.assert_array_equal(fresh[f], kept[f], err_msg=f)


def test_load_model_unknown_name_raises():
    with pytest.raises(FileNotFoundError, match="acrobot"):
        pm.load_model("humanoid", device="cpu")
