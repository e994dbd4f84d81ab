"""The port stands alone: no module of src/repro_torch, nor
chip_smoke.py, imports jax or the JAX package (repro).  Only the tests
import both."""
import ast
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[1]

FORBIDDEN = ("jax", "repro")


def _forbidden_imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                yield f"{path.relative_to(REPO)}:{node.lineno}: {name}"


def test_port_imports_neither_jax_nor_the_reference():
    """An AST scan of src/repro_torch and chip_smoke.py: no import of
    jax or of the repro package (repro_torch itself is allowed)."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    scanned = {f.relative_to(REPO).as_posix() for f in files}
    for module in ("models/transformer.py", "models/attention.py",
                   "serve/engine.py", "launch/serve.py",
                   "kernels/flash_attention.py", "configs/qwen15_05b.py",
                   "dist/compress.py", "debug.py",
                   "checkpoint/checkpoint.py", "runtime/actors.py",
                   "train/steps.py", "optim/optimizers.py",
                   "data/synthetic.py", "launch/train.py",
                   "runtime/workloads.py", "models/rwkv6.py",
                   "kernels/wkv6.py", "models/whisper.py",
                   "configs/whisper_small.py", "dist/meshctx.py",
                   "dist/sharding.py", "dist/collectives.py",
                   "launch/mesh.py", "models/parallel.py",
                   "launch/dryrun.py", "kernels/meta.py"):
        assert f"src/repro_torch/{module}" in scanned, module
    bad = [hit for f in files for hit in _forbidden_imports(f)]
    assert bad == []
