"""The whole slice on a single-instance scene: radiance_tpu_torch's
render vs radiance_tpu's on a 20k-triangle cut of the bench's city at
64x64, batch=2, depth 1 and 2 (the port's primary wave through stream3,
live-masked primary shadows, argsorted bounce waves).  The check and its bars are test_torch_engine.py's; the
city cases live in their own file so each file stays short under the
parallel test runner.
"""

import pytest

from test_torch_engine import (  # noqa: F401
    _city, _one_torch_thread, check_render, tracers)


@pytest.fixture(scope="module")
def city_inputs():
    return _city(64, 64)


@pytest.mark.parametrize("depth", [1, 2])
def test_city_render_matches_jax(monkeypatch, tracers, city_inputs,  # noqa: F811
                                 depth):
    check_render(monkeypatch, tracers, city_inputs, 64, depth)
