"""Error model of the port.

Copy of libzseek_tpu/errors.py: the reference library reports errors
through return codes and an 80-byte message buffer filled by set_error;
here they are typed exceptions carrying the same message, and
ERRBUF_SIZE survives as the bound errbuf() cuts a message to.
"""

ERRBUF_SIZE = 80


class ZseekError(Exception):
    """Base error (maps to the reference's errbuf text)."""

    def errbuf(self) -> str:
        """The message as it would appear in a zseek errbuf (truncated)."""
        return str(self)[: ERRBUF_SIZE - 1]


class FormatError(ZseekError):
    """Malformed archive / container data."""


class IOCallbackError(ZseekError):
    """A pluggable IO callback failed (wraps errno-style detail)."""


class ParameterError(ZseekError):
    """Invalid open/write/read parameters."""
