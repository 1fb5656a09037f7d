"""Common error type (reference src/util/error.rs)."""

from __future__ import annotations


class Error(Exception):
    """Base error for garage_tpu internals."""


class Message(Error):
    pass


class UnexpectedRpcMessage(Error):
    pass


class Timeout(Error):
    pass


class Quorum(Error):
    """Quorum not reached.

    Mirrors reference src/util/error.rs Quorum variant: carries how many
    successes were needed vs obtained and the individual errors.
    """

    def __init__(self, needed: int, got: int, errors: list[str]):
        super().__init__(
            f"could not reach quorum: {got}/{needed} successes; errors: {errors}"
        )
        self.needed = needed
        self.got = got
        self.errors = errors


OkOrMessage = None  # placeholder alias kept for parity with util::error naming
