"""The ctypes signatures of the port's CUDA entry points against their C
definitions, on the CPU (no GPU or nvcc needed).

``_build._SIGNATURES`` tells ctypes how to pass each argument of every
``extern "C"`` function in ``stamp_tpu_torch/ops/csrc/*.cu``.  A list one
argument short, or an int where the C side takes a pointer, truncates a
64-bit address silently; these tests read the sources and hold every entry
point to its list, parameter by parameter.
"""

import ctypes
import re

import pytest

from stamp_tpu_torch.ops import _build

_FUNCTION = re.compile(r"^([A-Za-z_][\w\s\*]*?)\b(\w+)\(([^)]*)\)\s*\{", re.MULTILINE)


def _extern_c_functions() -> dict[str, tuple[str, list[str]]]:
    """name → (return type, parameter declarations) of every function
    defined inside an ``extern "C" { ... }`` block of the kernel sources."""
    found = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)^\}  // extern "C"', text, re.DOTALL | re.MULTILINE):
            for ret, name, params in _FUNCTION.findall(block):
                assert name not in found, f"{name} defined twice"
                decls = [" ".join(p.split()) for p in params.split(",") if p.strip()]
                found[name] = (ret.strip(), decls)
    return found


def _ctype_of(decl: str):
    """The ctypes type a C parameter declaration must be passed as."""
    if "*" in decl:
        return ctypes.c_void_p
    kind = decl.rsplit(" ", 1)[0]
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


def test_every_extern_c_function_is_found():
    functions = _extern_c_functions()
    assert {"stamp_ln_dense", "stamp_ln_quant_dense", "stamp_cuda_error_string"} <= set(functions)
    assert set(functions) == set(_build._SIGNATURES) | set(_build._OTHER_SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES) + sorted(_build._OTHER_SIGNATURES))
def test_signature_matches_the_c_definition(name):
    functions = _extern_c_functions()
    assert name in functions, f"{name} has a ctypes signature but no extern \"C\" definition"
    ret, decls = functions[name]
    if name in _build._SIGNATURES:
        argtypes, restype = _build._SIGNATURES[name], ctypes.c_int
    else:
        argtypes, restype = _build._OTHER_SIGNATURES[name]
    assert len(argtypes) == len(decls), f"{name}: {len(argtypes)} ctypes arguments, {len(decls)} in C: {decls}"
    for i, (decl, got) in enumerate(zip(decls, argtypes)):
        assert got is _ctype_of(decl), f"{name} argument {i} ({decl!r}) passed as {got.__name__}"
    assert restype is (ctypes.c_char_p if "char*" in ret.replace(" ", "") else ctypes.c_int)


def test_pointer_parameters_are_never_ints():
    """The failure this file guards against: an address passed as c_int."""
    for name, (_, decls) in _extern_c_functions().items():
        argtypes = _build._SIGNATURES.get(name) or _build._OTHER_SIGNATURES[name][0]
        pointers = [i for i, d in enumerate(decls) if "*" in d]
        assert all(argtypes[i] is ctypes.c_void_p for i in pointers if i < len(argtypes)), name
