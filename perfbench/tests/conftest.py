"""The benchmark's own tests: ``python -m pytest -q perfbench/tests`` from the
root of the checkout (``-m cuda`` for those that need a card)."""
import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parents[1]
for p in (str(HERE.parent / "src"), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(scope="session")
def plan_cache(tmp_path_factory):
    """One directory of pinned plans for the session: each configuration is
    planned once."""
    return tmp_path_factory.mktemp("plans")
