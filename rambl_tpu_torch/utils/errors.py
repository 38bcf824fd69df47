"""User-facing error type: the port's copy of `rambl_tpu/utils/errors.py`.

Raise UserError only from input validators and config guards whose message
is actionable for the person invoking the tool; any other exception is a
bug and propagates with its traceback.
"""


class UserError(ValueError):
    """Invalid user input or configuration."""
