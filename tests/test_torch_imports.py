"""The port stands alone: ingp_tpu_torch and chip_smoke.py import
neither JAX nor anything of the JAX package ingp_tpu."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "ingp_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "ingp_tpu")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_no_jax_imports_in_source():
    assert (ROOT / "chip_smoke.py").exists()
    offenders = []
    for path in FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if _banned(n)]
    assert not offenders, offenders


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ingp_tpu'] = None\n"
        "import ingp_tpu_torch\n"
        "for m in pkgutil.walk_packages(ingp_tpu_torch.__path__,\n"
        "                               'ingp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import runpy\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_probe_modules_are_covered():
    """The probes' entry points are among the files the guards above
    read and import."""
    probes = {p.stem for p in FILES if p.parent.name == "probes"}
    assert {"kernel_split", "row_layouts", "vmem_gather",
            "gather_layouts"} <= probes
