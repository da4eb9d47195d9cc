"""What a run and the reference may load, by whole top-level names."""

import os
import subprocess
import sys

from harness import imports

from conftest import BENCH


def test_top_level_names_compare_whole():
    assert imports.forbidden_loaded({"boofcv_tpu_torch",
                                     "boofcv_tpu_torch.sfm.stereo_vo",
                                     "jaxtyping", "flaxen"}) == []
    assert imports.forbidden_loaded({"boofcv_tpu"}) == ["boofcv_tpu"]
    assert imports.forbidden_loaded({"boofcv_tpu.sfm"}) == ["boofcv_tpu"]
    assert imports.forbidden_loaded({"jax.numpy", "jaxlib.xla_client",
                                     "flax.linen"}) == ["flax", "jax",
                                                        "jaxlib"]


def test_the_reference_loads_numpy_alone():
    code = ("import sys; sys.path.insert(0, %r); import check, vo_ref; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'jax', 'jaxlib', 'flax', 'boofcv_tpu', "
            "'boofcv_tpu_torch', 'torch'}; print(sorted(bad))"
            % os.path.join(BENCH, "reference"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_benchmark_source_names_the_jax_package():
    bad = []
    for top, dirs, files in os.walk(BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if not f.endswith(".py") or f == os.path.basename(__file__):
                continue
            with open(os.path.join(top, f)) as fh:
                for line in fh:
                    words = line.replace(",", " ").split()
                    if words[:1] in (["import"], ["from"]) and any(
                            w.split(".")[0] in imports.FORBIDDEN
                            for w in words[1:2]):
                        bad.append((f, line.strip()))
    assert bad == []
