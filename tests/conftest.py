import os
import pathlib

import pytest

# Tests run on the CPU backend with an 8-device virtual mesh, so the
# sharding and multi-device code paths compile and run without a card.
# chip_smoke.py sets SEDEF_TESTS_ON_CARD=1 to run the tests marked ``gpu``
# in its own process, which already holds the card.
if not os.environ.get("SEDEF_TESTS_ON_CARD"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

from sedef_tpu.debug import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

# build the native runtime on fresh checkouts (tests pass without it via
# the Python fallbacks, but exercise the production dispatch when g++ is
# available)
_so = (pathlib.Path(__file__).parent.parent / "sedef_tpu" / "native"
       / "libsedef_native.so")
if not _so.exists():
    try:
        from sedef_tpu.native.build import build

        build(verbose=False)
    except Exception:
        pass

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; runs in chip_smoke.py phase A and "
        "skips elsewhere")


@pytest.fixture
def fixtures_dir():
    return FIXTURES


@pytest.fixture
def gpu():
    """The GPU device; skips the test on a machine without one."""
    from sedef_tpu.device import accelerator

    dev = accelerator()
    if dev is None:
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return dev
