"""Test configuration: an 8-device virtual CPU mesh unless JAX_PLATFORMS
says otherwise (``JAX_PLATFORMS=cuda pytest -m gpu`` runs the GPU tier)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)

# ---------------------------------------------------------------------------
# Test tiering: the default run (`pytest -q`) excludes the `slow` tier via
# pytest.ini addopts; run the rest with `pytest -m slow`.  Slow = golden f64
# physics runs with >~10 s serial cost (measured via --durations).  Names
# may be bare (all parametrizations) or carry a specific parametrization.
# ---------------------------------------------------------------------------
SLOW_TESTS = {
    # 3D golden physics (minutes each)
    "test_cg3d_laplace_law",
    "test_cg3d_wetting_contact_angle_neutral",
    "test_sc3d_phase_separation_and_mass",
    "test_coupled_3d_flow_transport",
    "test_washburn_capillary_rise_viscosity_ratio_001",
    "test_contact_angle_150_viscosity_contrast_100",
    "test_efs_viscosity_ratio_1000",
    "test_efs_open_boundaries_iso_depth",
    # 2D golden physics
    "test_capillary_intrusion_direction",
    "test_static_contact_angle_sweep",
    "test_static_contact_angle_neutral_wetting",
    "test_modified_periodic_color_swap_outlet",
    "test_laplace_law_csf[MRT]",
    # multichip golden equivalence (the cheap SC variant stays fast)
    "test_cg3d_sharded_equals_single",
    "test_csf_sharded_equals_single",
    "test_sharded_2d_mesh",
    # CLI end-to-end
    "test_cli_run_cg_small",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if item.name in SLOW_TESTS or base in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """The default JAX device, when it is a GPU; skips otherwise.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default backend: {dev.platform})")
    return dev
