"""Error model of the port.

Copy of the classes of libzseek_tpu/errors.py that the port raises: the
reference library reports errors through return codes and an 80-byte
message buffer; here they are typed exceptions.
"""


class ZseekError(Exception):
    """Base error (maps to the reference's errbuf text)."""


class FormatError(ZseekError):
    """Malformed archive / container data."""


class ParameterError(ZseekError):
    """Invalid open/write/read parameters."""
