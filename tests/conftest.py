"""Test configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device
sharding (``jax.sharding.Mesh``) is exercised without an accelerator.  The
backend is switched through ``jax.config`` before any backend is
initialised, so the suite stays on the CPU even where ``JAX_PLATFORMS``
names a GPU.  The GPU path is checked by ``chip_smoke.py`` at the repo
root, not by these tests.
"""

import pathlib

import jax
import pytest

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

DATA = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA


@pytest.fixture(scope="session")
def input_dir() -> pathlib.Path:
    return DATA / "input"


@pytest.fixture(scope="session")
def expected_dir() -> pathlib.Path:
    return DATA / "expected"


def frame(table):
    """A report table (``report.results.ResultTable``) as a pandas
    DataFrame, for frame comparisons in tests."""
    import pandas as pd

    return pd.DataFrame(table.columns)
