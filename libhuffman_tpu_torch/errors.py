"""Error taxonomy of the TPU-native Huffman codec.

Mirrors the reference's ``huf_error_t`` enum (reference: include/huffman/errors.h:6-27)
and its string table (reference: src/errors.c:5-15) as a Python exception hierarchy.
The reference propagates integer codes through goto-based routine macros
(include/huffman/sys.h); here the same *conditions* raise typed exceptions instead.

The public exception class is ``HuffmanError`` for parity with the reference Python
binding (reference: huffmanfile/huffmanfile.py:30-31), with one subclass per error
condition so callers can catch precisely.
"""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    """Numeric error codes, value-compatible with ``huf_error_t``."""

    SUCCESS = 0
    MEMORY_ALLOCATION = 1
    INVALID_ARGUMENT = 2
    READ_WRITE = 3
    FATAL = 4
    BTREE_OVERFLOW = 5
    BTREE_CORRUPTED = 6


# String table, value-for-value identical to src/errors.c:5-15.
ERROR_STRINGS = {
    ErrorCode.SUCCESS: "Success",
    ErrorCode.MEMORY_ALLOCATION: "Failed to allocate the requested memory block",
    ErrorCode.INVALID_ARGUMENT: "An invalid argument was specified to the function",
    ErrorCode.READ_WRITE: "Failed on read/write operation",
    ErrorCode.FATAL: "Fatal error",
    ErrorCode.BTREE_OVERFLOW: "Block is corrupted, Huffman tree has impossible size",
    ErrorCode.BTREE_CORRUPTED: (
        "Huffman tree is corrupted and cannot be used to decode the block"
    ),
}


def error_string(code: ErrorCode | int) -> str:
    """Equivalent of ``huf_error_string`` (src/errors.c:19-33)."""
    try:
        return ERROR_STRINGS[ErrorCode(code)]
    except ValueError:
        return "Unknown error"


class HuffmanError(Exception):
    """Raised when an error occurs during compression or decompression.

    Message format matches the reference binding's ``unwrap_exc``
    (huffmanfile/huffmanfile.py:34-37): ``"<error string>. <context message>"``.
    """

    code: ErrorCode = ErrorCode.FATAL

    def __init__(self, message: str = "", code: ErrorCode | None = None):
        if code is not None:
            self.code = code
        if message:
            super().__init__(f"{error_string(self.code)}. {message}")
        else:
            super().__init__(error_string(self.code))


class InvalidArgumentError(HuffmanError):
    code = ErrorCode.INVALID_ARGUMENT


class ReadWriteError(HuffmanError):
    """Short read / write failure (HUF_ERROR_READ_WRITE)."""

    code = ErrorCode.READ_WRITE


class BtreeOverflowError(HuffmanError):
    """Serialized tree length outside [0, 1024] (decoder.c:237-239)."""

    code = ErrorCode.BTREE_OVERFLOW


class BtreeCorruptedError(HuffmanError):
    """Walk reached a missing child mid-codeword (decoder.c:69-71), or an
    empty/underspecified tree was paired with a non-empty block.

    The reference NULL-dereferences on ``tree_length == 0`` with a non-zero
    block size (the check at decoder.c:226-228 is commented out); this
    framework deliberately raises this error instead (SURVEY.md §7 item 8).
    """

    code = ErrorCode.BTREE_CORRUPTED
