"""Directory abstraction + checksummed file IO.

reference: rucene src/core/store/directory/directory.rs:27-100 (Directory
trait), io/buffered_checksum_index_input.rs (CRC32 verification),
codec_util.rs:46-310 (header/footer framing).

Every index file is framed:
  header  = magic b"RTPU" + u32 version + u16 name_len + name bytes
  payload = format-specific
  footer  = u64 payload_end + magic + u32 crc32(everything before the crc)
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import Protocol

MAGIC = b"RTPU"
VERSION = 3  # v3: adaptive EF/bitset doc planes (v2: inline norm bytes)
MIN_READ_VERSION = 2  # v2 files decode fine (no EF blocks ever written)


class CorruptIndexError(Exception):
    pass


class ChecksumOutput:
    """Write-through wrapper accumulating CRC32 (analog of Lucene's
    ChecksumIndexOutput)."""

    def __init__(self, fh: io.BufferedWriter):
        self._fh = fh
        self._crc = 0
        self._pos = 0

    def write(self, data: bytes) -> None:
        self._fh.write(data)
        self._crc = zlib.crc32(data, self._crc)
        self._pos += len(data)

    @property
    def position(self) -> int:
        return self._pos

    def write_header(self, name: str) -> None:
        nb = name.encode("utf-8")
        self.write(MAGIC)
        self.write(struct.pack("<IH", VERSION, len(nb)))
        self.write(nb)

    def write_footer(self) -> None:
        self.write(struct.pack("<Q", self._pos))
        self.write(MAGIC)
        self._fh.write(struct.pack("<I", self._crc))

    def close(self) -> None:
        self._fh.flush()
        self._fh.close()


def check_footer(data: bytes, expect_name: str | None = None) -> bytes:
    """Validate framing + CRC of a whole file image; return the payload."""
    if len(data) < 26 or data[:4] != MAGIC:
        raise CorruptIndexError("bad header magic")
    version, name_len = struct.unpack_from("<IH", data, 4)
    if not (MIN_READ_VERSION <= version <= VERSION):
        raise CorruptIndexError(f"unsupported version {version}")
    name = data[10 : 10 + name_len].decode("utf-8")
    if expect_name is not None and name != expect_name:
        raise CorruptIndexError(f"file name mismatch: {name!r} != {expect_name!r}")
    crc_stored = struct.unpack_from("<I", data, len(data) - 4)[0]
    if zlib.crc32(data[:-4]) != crc_stored:
        raise CorruptIndexError("checksum mismatch")
    payload_end, = struct.unpack_from("<Q", data, len(data) - 16)
    if data[len(data) - 8 : len(data) - 4] != MAGIC:
        raise CorruptIndexError("bad footer magic")
    return data[10 + name_len : payload_end]


def check_footer_lazy(data, expect_name: str | None = None):
    """Framing validation WITHOUT the whole-file CRC pass: header magic/
    version/name + footer magic only, touching just the head and tail
    pages. For memory-mapped opens (reference mmap_index_input.rs:126 —
    Lucene never checksums on open either; full CRC verification lives in
    CheckIndex/merge). Returns a zero-copy payload view."""
    if len(data) < 26 or bytes(data[:4]) != MAGIC:
        raise CorruptIndexError("bad header magic")
    version, name_len = struct.unpack_from("<IH", data, 4)
    if not (MIN_READ_VERSION <= version <= VERSION):
        raise CorruptIndexError(f"unsupported version {version}")
    name = bytes(data[10 : 10 + name_len]).decode("utf-8")
    if expect_name is not None and name != expect_name:
        raise CorruptIndexError(f"file name mismatch: {name!r} != {expect_name!r}")
    if bytes(data[len(data) - 8 : len(data) - 4]) != MAGIC:
        raise CorruptIndexError("bad footer magic")
    (payload_end,) = struct.unpack_from("<Q", data, len(data) - 16)
    view = data if isinstance(data, memoryview) else memoryview(data)
    return view[10 + name_len : payload_end]


class LockObtainFailedError(Exception):
    """Another IndexWriter holds the directory's write lock
    (reference: LockValidatingDirectoryWrapper, directory.rs:105 — the
    reference only has advisory locking; this one actually excludes)."""


class Directory(Protocol):
    def list_all(self) -> list[str]: ...
    def file_exists(self, name: str) -> bool: ...
    def read_file(self, name: str) -> bytes: ...
    def file_size(self, name: str) -> int: ...
    def create_output(self, name: str) -> ChecksumOutput: ...
    def delete_file(self, name: str) -> None: ...
    def rename(self, src: str, dst: str) -> None: ...
    def sync(self, names: list[str]) -> None: ...


class FSDirectory:
    """Filesystem directory (reference fs_directory.rs:33). rename() is the
    two-phase-commit primitive (atomic on POSIX)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _p(self, name: str) -> str:
        return os.path.join(self.path, name)

    def list_all(self) -> list[str]:
        return sorted(os.listdir(self.path))

    def file_exists(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def read_file(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    def mmap_file(self, name: str) -> memoryview:
        """Zero-copy read-only mapping (reference mmap_index_input.rs:126):
        pages fault in on first touch instead of at open. The mapping
        outlives the returned view's slices; deleting the file under an
        active map is safe on POSIX."""
        import mmap

        with open(self._p(name), "rb") as f:
            try:
                mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError as e:  # zero-length file (torn write)
                raise CorruptIndexError(f"cannot map {name!r}: {e}") from None
        return memoryview(mm)

    def file_size(self, name: str) -> int:
        return os.path.getsize(self._p(name))

    def create_output(self, name: str) -> ChecksumOutput:
        return ChecksumOutput(open(self._p(name), "wb"))

    def delete_file(self, name: str) -> None:
        os.unlink(self._p(name))

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._p(src), self._p(dst))
        self._sync_dir()

    def sync(self, names: list[str]) -> None:
        for n in names:
            fd = os.open(self._p(n), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._sync_dir()

    def _sync_dir(self) -> None:
        fd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def obtain_lock(self, name: str = "write.lock"):
        """Kernel flock() on write.lock (what the reference's
        NativeFSLockFactory relies on, native_fs_lock_factory.rs). The OS
        drops the flock when the holder dies, so a crashed writer never
        wedges the index — no staleness heuristic, no unlink race (two
        racing takers serialize on LOCK_EX; exactly one wins LOCK_NB).
        The pid stamped inside the file is diagnostic only."""
        import fcntl

        path = self._p(name)
        fd = os.open(path, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            try:
                owner = os.read(fd, 64).decode("ascii", "replace") or "?"
            except OSError:
                owner = "?"
            os.close(fd)
            raise LockObtainFailedError(
                f"write lock held by pid {owner}: {path}"
            )
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        return _FileLock(self, name, fd)


class _FileLock:
    def __init__(self, directory, name: str, fd: int | None = None):
        self._dir = directory
        self._name = name
        self._fd = fd  # flock holder (FSDirectory); None for RAMDirectory
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._released = True
            if self._fd is not None:
                # flock path: NEVER unlink the lock file. Deleting it opens
                # the open-old-inode/flock-new-inode ABA window where two
                # writers each hold a lock on a different inode of the same
                # path. A present-but-unlocked write.lock is normal (same as
                # Lucene's NativeFSLockFactory).
                try:
                    os.close(self._fd)  # close => kernel releases the flock
                except OSError:
                    pass
            else:
                try:
                    self._dir.delete_file(self._name)
                except OSError:
                    pass


class RAMDirectory:
    """In-memory directory for tests (reference uses RAMOutputStream)."""

    def __init__(self):
        self.files: dict[str, bytes] = {}

    def list_all(self) -> list[str]:
        return sorted(self.files)

    def file_exists(self, name: str) -> bool:
        return name in self.files

    def read_file(self, name: str) -> bytes:
        return self.files[name]

    def file_size(self, name: str) -> int:
        return len(self.files[name])

    def create_output(self, name: str) -> ChecksumOutput:
        directory = self
        buf = io.BytesIO()
        out = ChecksumOutput(buf)  # type: ignore[arg-type]

        def close():
            directory.files[name] = buf.getvalue()
            buf.close()

        out.close = close  # type: ignore[method-assign]
        return out

    def delete_file(self, name: str) -> None:
        del self.files[name]

    def rename(self, src: str, dst: str) -> None:
        self.files[dst] = self.files.pop(src)

    def sync(self, names: list[str]) -> None:
        pass

    def obtain_lock(self, name: str = "write.lock"):
        if name in self.files:
            raise LockObtainFailedError(f"write lock held: {name}")
        self.files[name] = b"lock"
        return _FileLock(self, name)
