"""How the port finds its kernels' entry points, on the CPU, with stand-in
library objects: each symbol comes from whichever library exports it, so a
tree may move an entry point from one source to another (and
``tools/torch_kernel_ab.py`` times two such trees unchanged); a symbol that
no library exports raises an error that names it."""
import ctypes
from types import SimpleNamespace

import pytest

from fantasy_world_tpu_torch.ops import flash_attention as fa

SYMBOLS = {"fa_fwd_generic", "fa_fwd_d64", "fa_fwd_onekv", "fa_error_string",
           "fa_bwd_dq", "fa_bwd_dkv"}
# two trees' layouts: the one-key-block forward in a library of its own, or
# beside another forward (as before it moved)
ONLINE = ("fa_fwd_generic", "fa_fwd_d64", "fa_error_string")
BWD = ("fa_bwd_dq", "fa_bwd_dkv")
LAYOUTS = {
    "onekv_own_library": {"flash_attention_sm90": ONLINE,
                          "flash_attention_onekv": ("fa_fwd_onekv",),
                          "flash_attention_bwd": BWD},
    "onekv_in_another_library": {"flash_attention_sm90": ONLINE,
                                 "flash_attention": ("fa_fwd_onekv",),
                                 "flash_attention_bwd": BWD},
}


class _Fn:
    """A stand-in for a ctypes function: argtypes and restype settable."""

    def __init__(self, lib, sym):
        self.lib, self.sym = lib, sym


def _libs(layout):
    return {name: SimpleNamespace(**{s: _Fn(name, s) for s in syms})
            for name, syms in layout.items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bind_takes_each_entry_point_from_its_library(layout):
    fns = fa._bind(_libs(LAYOUTS[layout]))
    assert set(fns) == SYMBOLS
    for sym, fn in fns.items():
        assert fn.sym == sym and sym in LAYOUTS[layout][fn.lib]
        assert fn.restype == (ctypes.c_char_p if sym == "fa_error_string"
                              else ctypes.c_int)
    # q k v o m2 l, B Lq Lk H D, 9 strides, qscale, stream
    assert len(fns["fa_fwd_onekv"].argtypes) == 22


def test_bind_names_the_symbol_no_library_exports():
    layout = {"flash_attention_sm90": ONLINE, "flash_attention_bwd": BWD}
    with pytest.raises(RuntimeError, match="fa_fwd_onekv"):
        fa._bind(_libs(layout))
    with pytest.raises(RuntimeError, match="fa_bwd_dq"):
        fa._resolve({}, "fa_bwd_dq")


def test_call_raises_with_the_kernel_error_string(monkeypatch):
    """A nonzero return of an entry point raises, naming the entry point
    and the error ``fa_error_string`` gives for it: no fallback."""
    monkeypatch.setattr(fa, "_ENTRY_POINTS", {
        "fa_fwd_onekv": lambda *args: 1048577,
        "fa_error_string": lambda rc: b"cuTensorMapEncodeTiled returned "
                                      b"CUresult 1"})
    with pytest.raises(RuntimeError, match=r"fa_fwd_onekv failed: "
                       r"cuTensorMapEncodeTiled returned CUresult 1 "
                       r"\(1048577\)"):
        fa._call("fa_fwd_onekv", 0)
