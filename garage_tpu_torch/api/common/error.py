"""S3-style API errors -> XML error responses
(reference src/api/common/ error plumbing + s3 error codes)."""

from __future__ import annotations


class ApiError(Exception):
    code = "InternalError"
    status = 500

    def __init__(self, message: str = "", code: str | None = None, status: int | None = None):
        super().__init__(message or self.code)
        self.message = message or self.code
        if code:
            self.code = code
        if status:
            self.status = status


class BadRequest(ApiError):
    code = "InvalidRequest"
    status = 400


class Forbidden(ApiError):
    code = "AccessDenied"
    status = 403


class AuthError(ApiError):
    code = "SignatureDoesNotMatch"
    status = 403


class NoSuchBucket(ApiError):
    code = "NoSuchBucket"
    status = 404


class NoSuchKey(ApiError):
    code = "NoSuchKey"
    status = 404


class NoSuchUpload(ApiError):
    code = "NoSuchUpload"
    status = 404


class BucketNotEmpty(ApiError):
    code = "BucketNotEmpty"
    status = 409


class BucketAlreadyExists(ApiError):
    code = "BucketAlreadyExists"
    status = 409


class EntityTooLarge(ApiError):
    code = "EntityTooLarge"
    status = 400


class InvalidRange(ApiError):
    code = "InvalidRange"
    status = 416


class PreconditionFailed(ApiError):
    code = "PreconditionFailed"
    status = 412


class NotImplementedError_(ApiError):
    code = "NotImplemented"
    status = 501


class SlowDown(ApiError):
    """S3-semantic overload rejection (admission control,
    api/overload.py): AWS SDKs back off and retry on this code."""

    code = "SlowDown"
    status = 503


def error_xml(err: ApiError, resource: str = "", request_id: str = "") -> str:
    from xml.sax.saxutils import escape

    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        f"<Error><Code>{escape(err.code)}</Code>"
        f"<Message>{escape(err.message)}</Message>"
        f"<Resource>{escape(resource)}</Resource>"
        f"<RequestId>{escape(request_id)}</RequestId></Error>"
    )
