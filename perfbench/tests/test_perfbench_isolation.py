"""The harness loads neither JAX nor the JAX package, and refuses to run
without a card."""

import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "simd_raytracer_tpu")


def _env(**extra):
    env = dict(os.environ, **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_harness_and_reference_load_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n"
        "import pb.main, pb.reference, pb.check, pb.program, pb.trace\n"
        "import pb.faults, pb.host, pb.scenes, pb.uniforms, controls\n"
        "from pb import spec\n"
        "for name in ('frames', 'sgd_steps'):\n"
        "    spec.kind(name)\n"
        "for c in spec.Spec().data['configs']:\n"
        "    pb.scenes.scene_doc(spec.Spec().config(c['name']))\n"
        "for m in spec.Spec().data['end_to_end'] + "
        "spec.Spec().data['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "import simd_raytracer_tpu_torch.ops.grad\n"
        "import simd_raytracer_tpu_torch.parallel.tiles\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"                         if m.split('.')[0] in {FORBIDDEN!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{BENCH!r}]\n"
        "import pb.reference, pb.uniforms, pb.scenes, pb.spec\n"
        "for c in pb.spec.Spec().data['configs']:\n"
        "    pb.scenes.scene_doc(pb.spec.Spec().config(c['name']))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                         if m.split('.')[0].startswith("
        "'simd_raytracer_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "hw15_scene2.gi",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=_env(CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0
    assert not any(line.lstrip().startswith("{")
                   for line in out.stdout.splitlines())
    assert "no CUDA device" in out.stderr
