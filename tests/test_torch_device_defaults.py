"""Every public entry point of the port runs on the card unless the caller
asks for the CPU: no public function, method or constructor of
libzseek_tpu_torch defaults a `device` parameter to "cpu" (a string or
torch.device("cpu")).  The scan reads the sources (ast), so it sees
every module without importing it, and it is held to a few entry points
it must find defaulting to "cuda" and to snippets it must flag."""

import ast
import glob
import os

PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "libzseek_tpu_torch")


def _is_cpu(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return isinstance(node, ast.Call) and \
        ast.unparse(node.func) == "torch.device" and \
        any(_is_cpu(a) for a in node.args)


def _device_defaults(src: str):
    """(qualified name, default source) of each `device` parameter of a
    public module-level function or a public class's public method or
    constructor."""
    out = []

    def visit(fn, qual):
        a = fn.args
        pos = a.posonlyargs + a.args
        pairs = list(zip(pos[len(pos) - len(a.defaults):], a.defaults)) + \
            [(k, d) for k, d in zip(a.kwonlyargs, a.kw_defaults) if d]
        for arg, default in pairs:
            if arg.arg == "device":
                out.append((qual, default))

    funcs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(src).body:
        if isinstance(node, funcs) and not node.name.startswith("_"):
            visit(node, node.name)
        elif isinstance(node, ast.ClassDef) and \
                not node.name.startswith("_"):
            for m in node.body:
                if isinstance(m, funcs) and (
                        m.name == "__init__" or not m.name.startswith("_")):
                    visit(m, f"{node.name}.{m.name}")
    return out


def test_public_device_defaults_are_the_card():
    found, cpu = {}, []
    for path in sorted(glob.glob(os.path.join(PKG, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, PKG)
        for qual, default in _device_defaults(open(path).read()):
            found[f"{rel}:{qual}"] = ast.unparse(default)
            if _is_cpu(default):
                cpu.append(f"{rel}:{qual}")
    assert cpu == [], cpu
    for name in ("ops/zstd_decode.py:decode_frames",
                 "ops/zstd_decode.py:decode_frames_lanes",
                 "ops/zstd_decode.py:decode_frames_transcode",
                 "runtime/zstd_codec.py:ZstdCodec.__init__",
                 "runtime/codec.py:LZ4Codec.__init__",
                 "runtime/reader.py:Reader.__init__",
                 "api.py:open_reader", "api.py:Writer",
                 "convert.py:to_torch"):
        assert found.get(name) == "'cuda'", (name, found.get(name))
    flagged = _device_defaults(
        "def f(x, device='cpu'):\n    pass\n"
        "class C:\n    def __init__(self, *, device=torch.device('cpu')):\n"
        "        pass\n    def _private(self, device='cpu'):\n        pass\n"
        "def _g(device='cpu'):\n    pass\n")
    assert [(q, _is_cpu(d)) for q, d in flagged] == \
        [("f", True), ("C.__init__", True)]
