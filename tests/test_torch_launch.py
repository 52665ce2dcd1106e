"""The kernels' one launcher (``ops/kernels/build.launch``) on the CPU, through a
stub library: the arguments it passes, the error it raises, and how it counts
launches, eagerly and under a CUDA-graph capture's record.  And the seam it
keeps: no other kernel module reaches the stream or the library's error, and the
evaluator does not import the streaming lifter."""

import ast
import contextlib
import ctypes
import pathlib
import types

import pytest
import torch

from videopose3d_torch.ops.kernels import build

REPO = pathlib.Path(__file__).resolve().parents[1]
KERNELS = REPO / "videopose3d_torch" / "ops" / "kernels"


class StubLibrary:
    """The kernels' library as the launcher sees it: entry points that record their
    arguments and return ``code``, and the error string of a code."""

    def __init__(self, code=0):
        self.code = code
        self.calls = []

    def vp3d_stub(self, *args):
        self.calls.append(args)
        return self.code

    @staticmethod
    def vp3d_error_string(code):
        return f"stub error {code}".encode()


@pytest.fixture
def stub(monkeypatch):
    """A stub library in place of the built one, and a current stream of handle
    0x5eed on the (absent) card."""
    lib = StubLibrary()
    monkeypatch.setattr(build, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0x5eed))
    return lib


@pytest.mark.parametrize("count", [True, False])
def test_launch_passes_pointers_and_the_stream_and_counts_once(stub, count):
    launches = {"stub": 0, "other": 0}
    t = torch.zeros(4)
    ints = (ctypes.c_int * 2)(3, 4)
    build.launch("vp3d_stub", "cuda:0", t, None, 7, ints,
                 count=(launches, "stub") if count else None)
    (args,) = stub.calls
    assert args[:4] == (t.data_ptr(), None, 7, ints)
    assert isinstance(args[4], ctypes.c_void_p) and args[4].value == 0x5eed
    assert launches == {"stub": int(count), "other": 0}


@pytest.mark.parametrize("key,kernel", [("stub", "stub"), (None, "vp3d_stub")])
def test_failed_launch_raises_naming_the_kernel_and_counts_nothing(stub, key, kernel):
    stub.code = 98
    launches = {"stub": 0}
    with pytest.raises(RuntimeError,
                       match=f"the {kernel} kernel failed to launch: stub error 98 \\(98\\)"):
        build.launch("vp3d_stub", "cuda:0", torch.zeros(1),
                     count=None if key is None else (launches, key))
    assert launches == {"stub": 0}


def test_recorded_launches_count_once_per_replay(stub):
    """Launches inside ``recorded_launches`` (a capture runs none) are recorded in
    order, not counted; each ``count_replay`` counts them once; a failed launch is
    not recorded; after the block, launches count again."""
    first, second = {"a": 0}, {"b": 0}
    with build.recorded_launches() as record:
        build.launch("vp3d_stub", "cuda:0", count=(first, "a"))
        build.launch("vp3d_stub", "cuda:0", count=(second, "b"))
        build.launch("vp3d_stub", "cuda:0", count=(first, "a"))
        stub.code = 1
        with pytest.raises(RuntimeError):
            build.launch("vp3d_stub", "cuda:0", count=(second, "b"))
        stub.code = 0
    assert record == [(first, "a"), (second, "b"), (first, "a")]
    assert first == {"a": 0} and second == {"b": 0}
    for replays in (1, 2, 3):
        build.count_replay(record)
        assert first == {"a": 2 * replays} and second == {"b": replays}
    build.launch("vp3d_stub", "cuda:0", count=(second, "b"))
    assert second == {"b": 4} and len(record) == 3


def _calls(path):
    """Dotted names of the attributes ``path`` reads."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute):
            parts = [node.attr]
            value = node.value
            while isinstance(value, ast.Attribute):
                parts.append(value.attr)
                value = value.value
            if isinstance(value, ast.Name):
                yield ".".join([value.id, *reversed(parts)])


def test_only_the_launcher_reaches_the_stream_and_the_library_error():
    files = sorted(KERNELS.glob("*.py"))
    assert KERNELS / "streaming_fused.py" in files and len(files) > 5
    for path in files:
        names = set(_calls(path))
        reached = {n for n in names if n.endswith(".vp3d_error_string")
                   or n == "torch.cuda.current_stream"}
        assert not reached or path.name == "build.py", (path.name, reached)


def test_evaluator_does_not_import_the_streaming_lifter():
    """At module level or inside a function, in either import form."""
    tree = ast.parse((REPO / "videopose3d_torch" / "evaluate.py").read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            modules |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    assert "videopose3d_torch.ops.kernels.temporal_block_int8" in modules
    assert not any(m.startswith("videopose3d_torch.streaming") for m in modules), modules
