"""Minimal ctypes binding to libfuse.so.2 (FUSE 2.9, x86-64 Linux ABI).

The reference links a Go FUSE library (seaweedfs/fuse, SURVEY §2.9); the
image bakes no Python FUSE package, so this speaks the libfuse 2 C ABI
directly: a `fuse_operations` struct of callback pointers handed to
`fuse_main_real`. Single-threaded (-s) so callbacks re-enter Python
safely under the GIL.

The port's copy of ``seaweedfs_tpu/mount/fuse_ctypes.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
from ctypes import (
    CFUNCTYPE,
    POINTER,
    Structure,
    c_char_p,
    c_int,
    c_long,
    c_size_t,
    c_uint,
    c_ulong,
    c_void_p,
)


class c_stat(Structure):
    _fields_ = [  # x86_64 linux struct stat
        ("st_dev", c_ulong),
        ("st_ino", c_ulong),
        ("st_nlink", c_ulong),
        ("st_mode", c_uint),
        ("st_uid", c_uint),
        ("st_gid", c_uint),
        ("__pad0", c_int),
        ("st_rdev", c_ulong),
        ("st_size", c_long),
        ("st_blksize", c_long),
        ("st_blocks", c_long),
        ("st_atime", c_long),
        ("st_atimensec", c_ulong),
        ("st_mtime", c_long),
        ("st_mtimensec", c_ulong),
        ("st_ctime", c_long),
        ("st_ctimensec", c_ulong),
        ("__reserved", c_long * 3),
    ]


class fuse_file_info(Structure):
    _fields_ = [
        ("flags", c_int),
        ("fh_old", c_ulong),
        ("writepage", c_int),
        ("bits", c_uint),  # direct_io etc. bitfields, unused here
        ("fh", c_ulong),
        ("lock_owner", c_ulong),
    ]


fuse_fill_dir_t = CFUNCTYPE(
    c_int, c_void_p, c_char_p, POINTER(c_stat), c_long
)

_GETATTR = CFUNCTYPE(c_int, c_char_p, POINTER(c_stat))
# output buffer is c_void_p: ctypes converts c_char_p callback args to
# bytes, which would lose the pointer we must memmove into
_READLINK = CFUNCTYPE(c_int, c_char_p, c_void_p, c_size_t)
_MKNOD = CFUNCTYPE(c_int, c_char_p, c_uint, c_ulong)
_MKDIR = CFUNCTYPE(c_int, c_char_p, c_uint)
_UNLINK = CFUNCTYPE(c_int, c_char_p)
_RMDIR = CFUNCTYPE(c_int, c_char_p)
_SYMLINK = CFUNCTYPE(c_int, c_char_p, c_char_p)
_RENAME = CFUNCTYPE(c_int, c_char_p, c_char_p)
_LINK = CFUNCTYPE(c_int, c_char_p, c_char_p)
_CHMOD = CFUNCTYPE(c_int, c_char_p, c_uint)
_CHOWN = CFUNCTYPE(c_int, c_char_p, c_uint, c_uint)
_TRUNCATE = CFUNCTYPE(c_int, c_char_p, c_long)
_OPEN = CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info))
_READ = CFUNCTYPE(
    c_int, c_char_p, c_void_p, c_size_t, c_long,
    POINTER(fuse_file_info),
)
_WRITE = CFUNCTYPE(
    c_int, c_char_p, c_void_p, c_size_t, c_long,
    POINTER(fuse_file_info),
)
_FLUSH = CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info))
_RELEASE = CFUNCTYPE(c_int, c_char_p, POINTER(fuse_file_info))
_READDIR = CFUNCTYPE(
    c_int, c_char_p, c_void_p, fuse_fill_dir_t, c_long,
    POINTER(fuse_file_info),
)
_CREATE = CFUNCTYPE(
    c_int, c_char_p, c_uint, POINTER(fuse_file_info)
)
_UTIMENS = CFUNCTYPE(c_int, c_char_p, c_void_p)
_SETXATTR = CFUNCTYPE(
    c_int, c_char_p, c_char_p, c_void_p, c_size_t, c_int
)
_GETXATTR = CFUNCTYPE(c_int, c_char_p, c_char_p, c_void_p, c_size_t)
_LISTXATTR = CFUNCTYPE(c_int, c_char_p, c_void_p, c_size_t)
_REMOVEXATTR = CFUNCTYPE(c_int, c_char_p, c_char_p)


class fuse_operations(Structure):
    _fields_ = [  # FUSE 2.9 layout (fuse.h), order is the ABI
        ("getattr", _GETATTR),
        ("readlink", _READLINK),
        ("getdir", c_void_p),
        ("mknod", _MKNOD),
        ("mkdir", _MKDIR),
        ("unlink", _UNLINK),
        ("rmdir", _RMDIR),
        ("symlink", _SYMLINK),
        ("rename", _RENAME),
        ("link", _LINK),
        ("chmod", _CHMOD),
        ("chown", _CHOWN),
        ("truncate", _TRUNCATE),
        ("utime", c_void_p),
        ("open", _OPEN),
        ("read", _READ),
        ("write", _WRITE),
        ("statfs", c_void_p),
        ("flush", _FLUSH),
        ("release", _RELEASE),
        ("fsync", c_void_p),
        ("setxattr", _SETXATTR),
        ("getxattr", _GETXATTR),
        ("listxattr", _LISTXATTR),
        ("removexattr", _REMOVEXATTR),
        ("opendir", c_void_p),
        ("readdir", _READDIR),
        ("releasedir", c_void_p),
        ("fsyncdir", c_void_p),
        ("init", c_void_p),
        ("destroy", c_void_p),
        ("access", c_void_p),
        ("create", _CREATE),
        ("ftruncate", c_void_p),
        ("fgetattr", c_void_p),
        ("lock", c_void_p),
        ("utimens", _UTIMENS),
        ("bmap", c_void_p),
        ("flag_nullpath_ok", c_uint, 1),
        ("flag_nopath", c_uint, 1),
        ("flag_utime_omit_ok", c_uint, 1),
        ("flag_reserved", c_uint, 29),
        ("ioctl", c_void_p),
        ("poll", c_void_p),
        ("write_buf", c_void_p),
        ("read_buf", c_void_p),
        ("flock", c_void_p),
        ("fallocate", c_void_p),
    ]


class FuseError(OSError):
    pass


def _wrap(functype, fn):
    """Exception-safe callback: OSError.errno → -errno, else -EIO."""

    def inner(*args):
        try:
            out = fn(*args)
            return 0 if out is None else out
        except OSError as e:
            return -(e.errno or errno.EIO)
        except Exception:
            return -errno.EIO

    return functype(inner)


class FUSE:
    """Mount `operations` (an object with python methods) at mountpoint.

    operations methods (all optional except getattr/readdir):
      getattr(path) -> dict(st_mode, st_size, st_mtime, st_nlink, ...)
      readdir(path) -> list[str]
      read(path, size, offset, fh) -> bytes
      write(path, data, offset, fh) -> int
      create(path, mode) / open(path, flags) -> fh int
      truncate(path, length), unlink(path), mkdir(path, mode),
      rmdir(path), rename(old, new), flush/release(path, fh)
    """

    def __init__(self, operations, mountpoint: str,
                 foreground: bool = True, options: str = ""):
        libname = ctypes.util.find_library("fuse") or "libfuse.so.2"
        self.lib = ctypes.CDLL(libname)
        self.ops_obj = operations
        ops = fuse_operations()
        self._keep = []  # keep callbacks alive

        def set_cb(name, functype, impl):
            cb = _wrap(functype, impl)
            self._keep.append(cb)
            setattr(ops, name, cb)

        o = operations
        set_cb("getattr", _GETATTR, self._getattr)
        set_cb("readdir", _READDIR, self._readdir)
        if hasattr(o, "read"):
            set_cb("read", _READ, self._read)
        if hasattr(o, "write"):
            set_cb("write", _WRITE, self._write)
        if hasattr(o, "create"):
            set_cb("create", _CREATE, self._create)
        if hasattr(o, "open"):
            set_cb("open", _OPEN, self._open)
        if hasattr(o, "truncate"):
            set_cb(
                "truncate", _TRUNCATE,
                lambda p, ln: o.truncate(p.decode(), ln),
            )
        if hasattr(o, "unlink"):
            set_cb("unlink", _UNLINK, lambda p: o.unlink(p.decode()))
        if hasattr(o, "mkdir"):
            set_cb(
                "mkdir", _MKDIR,
                lambda p, m: o.mkdir(p.decode(), m),
            )
        if hasattr(o, "rmdir"):
            set_cb("rmdir", _RMDIR, lambda p: o.rmdir(p.decode()))
        if hasattr(o, "rename"):
            set_cb(
                "rename", _RENAME,
                lambda a, b: o.rename(a.decode(), b.decode()),
            )
        if hasattr(o, "flush"):
            set_cb(
                "flush", _FLUSH,
                lambda p, fi: o.flush(
                    p.decode(), fi.contents.fh if fi else 0
                ),
            )
        if hasattr(o, "release"):
            set_cb(
                "release", _RELEASE,
                lambda p, fi: o.release(
                    p.decode(), fi.contents.fh if fi else 0
                ),
            )
        if hasattr(o, "symlink"):
            set_cb(
                "symlink", _SYMLINK,
                lambda t, lp: o.symlink(t.decode(), lp.decode()),
            )
        if hasattr(o, "readlink"):
            set_cb("readlink", _READLINK, self._readlink)
        if hasattr(o, "link"):
            set_cb(
                "link", _LINK,
                lambda a, b: o.link(a.decode(), b.decode()),
            )
        if hasattr(o, "setxattr"):
            set_cb("setxattr", _SETXATTR, self._setxattr)
        if hasattr(o, "getxattr"):
            set_cb("getxattr", _GETXATTR, self._getxattr)
        if hasattr(o, "listxattr"):
            set_cb("listxattr", _LISTXATTR, self._listxattr)
        if hasattr(o, "removexattr"):
            set_cb(
                "removexattr", _REMOVEXATTR,
                lambda p, n: o.removexattr(p.decode(), n.decode()),
            )
        set_cb("chmod", _CHMOD, lambda p, m: 0)
        set_cb("chown", _CHOWN, lambda p, u, g: 0)
        set_cb("utimens", _UTIMENS, lambda p, ts: 0)

        args = [b"seaweedfs-tpu", b"-f", b"-s"]
        if options:
            args += [b"-o", options.encode()]
        args.append(os.fsencode(mountpoint))
        argv = (c_char_p * len(args))(*args)
        self.lib.fuse_main_real.argtypes = [
            c_int, POINTER(c_char_p), POINTER(fuse_operations),
            c_size_t, c_void_p,
        ]
        err = self.lib.fuse_main_real(
            len(args), argv, ctypes.byref(ops),
            ctypes.sizeof(ops), None,
        )
        if err:
            raise FuseError(errno.EIO, f"fuse_main failed: {err}")

    # -- callback shims --------------------------------------------------

    def _getattr(self, path, stbuf):
        attrs = self.ops_obj.getattr(path.decode())
        ctypes.memset(stbuf, 0, ctypes.sizeof(c_stat))
        st = stbuf.contents
        st.st_mode = attrs.get("st_mode", 0o100644)
        st.st_size = attrs.get("st_size", 0)
        st.st_nlink = attrs.get("st_nlink", 1)
        st.st_mtime = int(attrs.get("st_mtime", 0))
        st.st_ctime = int(attrs.get("st_ctime", st.st_mtime))
        st.st_atime = int(attrs.get("st_atime", st.st_mtime))
        st.st_uid = attrs.get("st_uid", os.getuid())
        st.st_gid = attrs.get("st_gid", os.getgid())
        st.st_blocks = (st.st_size + 511) // 512
        st.st_blksize = 4096
        return 0

    def _readdir(self, path, buf, filler, offset, fi):
        names = [".", ".."] + list(
            self.ops_obj.readdir(path.decode())
        )
        for name in names:
            if filler(buf, name.encode(), None, 0) != 0:
                break
        return 0

    def _read(self, path, buf, size, offset, fi):
        fh = fi.contents.fh if fi else 0
        data = self.ops_obj.read(path.decode(), size, offset, fh)
        n = min(len(data), size)
        ctypes.memmove(buf, data, n)
        return n

    def _write(self, path, buf, size, offset, fi):
        fh = fi.contents.fh if fi else 0
        data = ctypes.string_at(buf, size)
        return self.ops_obj.write(path.decode(), data, offset, fh)

    def _create(self, path, mode, fi):
        fh = self.ops_obj.create(path.decode(), mode)
        if fi:
            fi.contents.fh = fh or 0
        return 0

    def _open(self, path, fi):
        fh = self.ops_obj.open(
            path.decode(), fi.contents.flags if fi else 0
        )
        if fi:
            fi.contents.fh = fh or 0
        return 0

    def _readlink(self, path, buf, bufsize):
        target = self.ops_obj.readlink(path.decode()).encode()
        n = min(len(target), bufsize - 1)
        ctypes.memmove(buf, target, n)
        ctypes.memset(buf + n, 0, 1)
        return 0

    # xattr ABI: size==0 probes the needed length; a too-small buffer
    # is -ERANGE (getfattr and rsync -X probe exactly this way)

    def _setxattr(self, path, name, value, size, flags):
        val = ctypes.string_at(value, size) if size else b""
        return self.ops_obj.setxattr(
            path.decode(), name.decode(), val, flags
        )

    def _getxattr(self, path, name, buf, size):
        val = self.ops_obj.getxattr(path.decode(), name.decode())
        if size == 0:
            return len(val)
        if size < len(val):
            return -errno.ERANGE
        ctypes.memmove(buf, val, len(val))
        return len(val)

    def _listxattr(self, path, buf, size):
        names = self.ops_obj.listxattr(path.decode())
        blob = b"".join(n.encode() + b"\0" for n in names)
        if size == 0:
            return len(blob)
        if size < len(blob):
            return -errno.ERANGE
        ctypes.memmove(buf, blob, len(blob))
        return len(blob)
