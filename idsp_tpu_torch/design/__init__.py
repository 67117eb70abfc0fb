"""Filter/controller coefficient design (float math, host-side); a
copy of `idsp_tpu.design`, pure numpy.

Equivalent of the reference's coefficient builders: the audio-EQ-cookbook
`Filter` and `WebAudio` (src/iir/coefficients.rs), the PID `Builder`/
`Pid`/`Units` (src/iir/pid.rs), `freqz` response evaluation
(src/iir/response.rs), and the validation `Error` taxonomy
(src/iir/error.rs).  All closed-form float64 math producing normalized
``[b0,b1,b2,a1,a2]`` arrays ready for `filters.biquad` (float) or
`quantize_ba` (fixed point).
"""

from .errors import DesignError
from .coefficients import Filter, FilterType, Shape, WebAudio
from .pid import Action, Order, PidBuilder, Pid, Units
from .response import freqz, freqz_ba5

__all__ = [
    "Action",
    "DesignError",
    "Filter",
    "FilterType",
    "Order",
    "Pid",
    "PidBuilder",
    "Shape",
    "Units",
    "WebAudio",
    "freqz",
    "freqz_ba5",
]
