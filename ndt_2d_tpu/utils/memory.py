"""Host-heap hygiene for long sessions.

A loop-closure pass allocates and frees tens of MB of short-lived host
buffers (padded candidate-window batches, fetched row results, solver
temporaries); glibc's allocator retains the freed pages in its arenas, so a
long session's RSS creeps even though no Python object leaks.  A
``malloc_trim(0)`` after each pass returns those pages; without it a
closure-dense multi-lap session's RSS grows with every pass
(benchmarks/memory_attribution.py measures both arms).  The reference's
three-thread C++ process has the same allocator but frees its
per-candidate buffers eagerly and allocates them far smaller
(ndt_mapper.cpp:623-663).

``trim_host_heap`` is a best-effort no-op anywhere glibc isn't available.
"""

from __future__ import annotations

import ctypes
import os
import sys

_libc = None
_checked = False


def trim_host_heap() -> bool:
    """Return freed heap pages to the OS (glibc ``malloc_trim``).

    Safe to call from any thread at any time; returns True iff memory was
    actually released.  Costs ~1 ms on a multi-GB heap — negligible at the
    loop-closure-pass cadence it is called on.  ``NDT2D_HEAP_TRIM=0``
    disables it (used by benchmarks/memory_attribution.py to A/B the
    retention).
    """
    global _libc, _checked
    if not _checked:
        _checked = True
        if os.environ.get("NDT2D_HEAP_TRIM", "1") == "0":
            _libc = None
        elif sys.platform.startswith("linux"):
            try:
                lib = ctypes.CDLL("libc.so.6", use_errno=True)
                lib.malloc_trim.argtypes = (ctypes.c_size_t,)
                lib.malloc_trim.restype = ctypes.c_int
                _libc = lib
            except (OSError, AttributeError):
                _libc = None
    if _libc is None:
        return False
    try:
        return bool(_libc.malloc_trim(0))
    except Exception:
        return False
