"""utils — debug instrumentation and profiling helpers.

The reference's debug tier is assert-dense nancheck instrumentation compiled
into THRUST_DEBUG builds (src/detail/checknan.hpp, used after every phase,
e.g. particles_step.ipp:114-128, coal.ipp:453-456); the equivalent here
is runtime-gated: set LIBCLOUD_DEBUG=1 and every step phase is
followed by a finite-ness sweep that raises with the phase named.  The
reference ships no profiler (SURVEY section 5 asks for a step timer); the
StepTimer here is the missing utility.  ``device`` holds the one
device-capability query and the persistent compilation cache helper.
"""

from .debug import DEBUG_ENV, nancheck, nancheck_state
from .device import enable_compilation_cache, on_accelerator
from .timing import StepTimer

__all__ = ["DEBUG_ENV", "nancheck", "nancheck_state", "StepTimer",
           "enable_compilation_cache", "on_accelerator"]
