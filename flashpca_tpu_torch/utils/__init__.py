from .logging import timestamp, log, set_show_timestamp
from .formats import format_g
from .device import resolve_device, default_dtype
