"""The check that nothing the benchmark loads is JAX or the JAX package."""

import os

from benchmark.harness import purity, spec


def test_benchmark_sources_import_nothing_forbidden():
    assert purity.scan(spec.BENCH_DIR) == {}


def test_reference_and_yardstick_import_nothing_of_the_program():
    port = {"kuiperllama_tpu_torch"}
    for sub in ("reference", "counts", "layouts"):
        assert purity.scan(os.path.join(spec.BENCH_DIR, sub), port) == {}
    for name in ("weights", "traffic", "stats", "check", "purity", "spec", "trace",
                 "record", "readers"):
        with open(os.path.join(spec.BENCH_DIR, "harness", f"{name}.py")) as f:
            assert not purity.imported_names(f.read()) & port, name


def test_only_the_drivers_the_adapters_and_program_import_the_program():
    found = purity.scan(spec.BENCH_DIR, {"kuiperllama_tpu_torch"})
    allowed = [p for p in found if p.startswith(("entries" + os.sep, "adapters" + os.sep,
                                                 "tests" + os.sep))
               or p == os.path.join("harness", "program.py")]
    assert sorted(found) == sorted(allowed)
    assert os.path.join("harness", "program.py") in found
    assert os.path.join("adapters", "qwen2.py") in found


def test_names_are_compared_whole_by_their_top_level_part():
    src = ("import jax.numpy as jnp\nfrom kuiperllama_tpu.ops import x\n"
           "import kuiperllama_tpu_torch.serving\nfrom tools import roofline\n"
           "import benchmark.harness\nfrom . import local\n")
    assert purity.imported_names(src) & purity.FORBIDDEN == {"jax", "kuiperllama_tpu",
                                                             "tools"}
    mods = {"kuiperllama_tpu_torch.ops": 1, "bench_x": 1, "torch": 1}
    assert purity.loaded(modules=mods) == []
    assert purity.loaded(modules=dict(mods, **{"jaxlib.xla": 1, "bench": 1})) == [
        "bench", "jaxlib"]


def test_scan_finds_a_forbidden_import(tmp_path):
    (tmp_path / "a.py").write_text("import os\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.py").write_text("from flax import linen\n")
    assert purity.scan(str(tmp_path)) == {os.path.join("sub", "b.py"): ["flax"]}
