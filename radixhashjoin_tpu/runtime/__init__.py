"""Host runtime: native (C++) fast paths for IO-/parse-bound host work.

The reference's host substrate is C++ (mmap loader structs.cpp:17-63,
char-level parser Query.cpp:10-63, result printer Query.cpp:226-235). The
engine's device path is JAX/XLA; this package provides the equivalent
native host pieces — a multithreaded columnar loader with load-time stats,
a workload parser, and a result formatter — as a small C++ library bound
via ctypes, with bit-identical pure-Python fallbacks (storage.py,
workload.py) when the library isn't built.

Build: `make -C radixhashjoin_tpu/runtime/native` (or it builds lazily on
first use when a toolchain is present).
"""

from .native import (native_available, load_relation_native,
                     parse_work_native, format_results_native)

__all__ = ["native_available", "load_relation_native", "parse_work_native",
           "format_results_native"]
