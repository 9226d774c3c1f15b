"""No module of the benchmark imports JAX, Flax, Optax or the JAX package
(top-level names compared whole: the program's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFUSED = {"jax", "jaxlib", "flax", "optax", "cartnet_tpu"}


def imported(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None))
                == "import_module" and node.args
                and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def sources():
    for d, _, files in os.walk(HERE):
        if ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: imported(p) & REFUSED for p in sources()}
    assert not {p: n for p, n in found.items() if n}
    assert len(found) > 20


def test_reference_is_independent_of_the_program():
    ref = os.path.join(HERE, "reference")
    for p in sources():
        if p.startswith(ref):
            assert not imported(p) & (REFUSED | {"cartnet_tpu_torch"}), p


def test_whole_names_are_compared():
    import tempfile
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write("import cartnet_tpu_torch.runner\nfrom jax import numpy\n")
    try:
        assert imported(f.name) == {"cartnet_tpu_torch", "jax"}
        assert imported(f.name) & REFUSED == {"jax"}
    finally:
        os.unlink(f.name)
