"""Pure-Python ROS1 bag (format v2.0) reader + writer, no ROS required (a
copy of the JAX package's data/rosbag1.py, which imports nothing of JAX
itself but cannot be imported without it through that package).

The reference's dataset converter (its `scripts/bag2data.py:24-159`) runs
only on a ROS1 machine (imports rosbag, cv_bridge, tf). This module
re-implements the two pieces that matter for converting a capture bag
offline:

  * the on-disk container format (http://wiki.ros.org/Bags/Format/2.0):
    length-prefixed records with `name=value` header fields, chunked
    message storage with none/bz2 (and lz4 when available) compression,
    connection records, and the trailing index section, and
  * a *definition-driven* message (de)serializer: every connection record
    carries the full concatenated `.msg` definition text of its type, so
    messages are decoded generically from that text — no hardcoded
    per-message layouts, and bags with unknown message types still decode.

Scope: everything `scripts/bag2data.py` needs (sensor_msgs/Image,
CompressedImage, Imu, CameraInfo; geometry_msgs/PoseStamped;
nav_msgs/Odometry; tf2_msgs/TFMessage) plus arbitrary other types via
their embedded definitions. The writer produces tool-compatible bags
(bag header padded to 4 KiB, per-chunk index-data records, trailing
connection + chunk-info records) and is used by the test suite to build
synthetic capture bags.

Messages decode to attribute-access objects (`msg.pose.pose.position.x`),
mirroring rospy's generated classes; `time` fields decode to `RosTime`
with `.secs/.nsecs/.to_sec()`.
"""
from __future__ import annotations

import bz2
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# record / header primitives
# ---------------------------------------------------------------------------

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_TIME = struct.Struct("<II")


def _pack_header(fields: Dict[str, bytes]) -> bytes:
    out = []
    for name, value in fields.items():
        item = name.encode() + b"=" + value
        out.append(_U32.pack(len(item)) + item)
    return b"".join(out)


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields: Dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        (n,) = _U32.unpack_from(buf, off)
        off += 4
        item = buf[off:off + n]
        off += n
        k, _, v = item.partition(b"=")
        fields[k.decode()] = v
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    end = len(buf)
    while off < end:
        (hlen,) = _U32.unpack_from(buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = _U32.unpack_from(buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


# ---------------------------------------------------------------------------
# message definitions -> field lists
# ---------------------------------------------------------------------------

_PRIMITIVES = {
    "bool": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "byte": ("b", 1), "char": ("B", 1),
    "int16": ("h", 2), "uint16": ("H", 2),
    "int32": ("i", 4), "uint32": ("I", 4),
    "int64": ("q", 8), "uint64": ("Q", 8),
    "float32": ("f", 4), "float64": ("d", 8),
}
_NP_DTYPE = {
    "bool": np.bool_, "int8": np.int8, "uint8": np.uint8,
    "byte": np.int8, "char": np.uint8,
    "int16": np.int16, "uint16": np.uint16,
    "int32": np.int32, "uint32": np.uint32,
    "int64": np.int64, "uint64": np.uint64,
    "float32": np.float32, "float64": np.float64,
}


class RosTime:
    """rospy.Time lookalike (secs/nsecs + to_sec)."""

    __slots__ = ("secs", "nsecs")

    def __init__(self, secs: int = 0, nsecs: int = 0):
        self.secs = int(secs)
        self.nsecs = int(nsecs)

    def to_sec(self) -> float:
        return self.secs + self.nsecs * 1e-9

    def __repr__(self):
        return f"RosTime({self.secs}, {self.nsecs})"

    def __eq__(self, other):
        return (self.secs, self.nsecs) == (other.secs, other.nsecs)

    def __lt__(self, other):
        return (self.secs, self.nsecs) < (other.secs, other.nsecs)


class Msg:
    """Decoded message: plain attribute bag (like rospy generated classes)."""

    def __init__(self, _type: str, **kw):
        self._type = _type
        self.__dict__.update(kw)

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in self.__dict__.items()
                         if k != "_type")
        return f"Msg({self._type}: {body})"


# field: (name, base_type, array_len) with array_len None (scalar),
# -1 (variable length), or N (fixed length)
Field = Tuple[str, str, Optional[int]]


def parse_definition(root_type: str, text: str) -> Dict[str, List[Field]]:
    """Parse a concatenated message-definition text (the `message_definition`
    connection field: root .msg body, then `====`-separated `MSG: pkg/Name`
    sub-definitions) into {full_type: [fields]} with all embedded types
    resolved to full names."""
    blocks: List[Tuple[str, List[str]]] = []
    cur_name, cur_lines = root_type, []
    for line in text.splitlines():
        if line.startswith("===="):
            blocks.append((cur_name, cur_lines))
            cur_name, cur_lines = None, []
        elif cur_name is None and line.startswith("MSG:"):
            cur_name = line.split(":", 1)[1].strip()
        else:
            cur_lines.append(line)
    blocks.append((cur_name, cur_lines))

    known = [name for name, _ in blocks if name]
    types: Dict[str, List[Field]] = {}
    for name, lines in blocks:
        if name is None:
            continue
        pkg = name.rpartition("/")[0]
        fields: List[Field] = []
        for raw in lines:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split(None, 1)
            if len(parts) != 2:
                continue
            ftype, rest = parts
            rest = rest.strip()
            if "=" in rest:      # constant declaration (incl. string consts)
                continue
            fname = rest.split()[0]
            alen: Optional[int] = None
            if ftype.endswith("]"):
                ftype, _, dim = ftype.rstrip("]").partition("[")
                alen = int(dim) if dim else -1
            if ftype not in _PRIMITIVES and ftype not in ("string", "time",
                                                          "duration"):
                ftype = _resolve_type(ftype, pkg, known)
            fields.append((fname, ftype, alen))
        types[name] = fields
    return types


def _resolve_type(name: str, pkg: str, known: Sequence[str]) -> str:
    if name == "Header":
        return "std_msgs/Header"
    if "/" in name:
        return name
    if pkg and f"{pkg}/{name}" in known:
        return f"{pkg}/{name}"
    matches = [k for k in known if k.endswith("/" + name)]
    if len(matches) == 1:
        return matches[0]
    # unresolvable now; may still be defined in DEFS at decode time
    return f"{pkg}/{name}" if pkg else name


# ---------------------------------------------------------------------------
# generic (de)serializer
# ---------------------------------------------------------------------------

def _decode_value(buf: bytes, off: int, ftype: str, alen: Optional[int],
                  types: Dict[str, List[Field]]):
    if ftype in _PRIMITIVES:
        code, size = _PRIMITIVES[ftype]
        if alen is None:
            (v,) = struct.unpack_from("<" + code, buf, off)
            return (bool(v) if ftype == "bool" else v), off + size
        n = alen
        if n == -1:
            (n,) = _U32.unpack_from(buf, off)
            off += 4
        arr = np.frombuffer(buf, dtype=np.dtype(_NP_DTYPE[ftype]).newbyteorder("<"),
                            count=n, offset=off)
        return arr, off + n * size
    if ftype == "string":
        if alen is not None:
            out = []
            n = alen
            if n == -1:
                (n,) = _U32.unpack_from(buf, off)
                off += 4
            for _ in range(n):
                s, off = _decode_value(buf, off, "string", None, types)
                out.append(s)
            return out, off
        (n,) = _U32.unpack_from(buf, off)
        off += 4
        return buf[off:off + n].decode("utf-8", errors="replace"), off + n
    if ftype in ("time", "duration"):
        if alen is not None:
            raise NotImplementedError("time/duration arrays")
        secs, nsecs = _TIME.unpack_from(buf, off)
        return RosTime(secs, nsecs), off + 8
    # complex type
    fields = types.get(ftype)
    if fields is None:
        fields = _builtin_fields(ftype, types)
    if alen is None:
        return _decode_struct(buf, off, ftype, fields, types)
    n = alen
    if n == -1:
        (n,) = _U32.unpack_from(buf, off)
        off += 4
    out = []
    for _ in range(n):
        m, off = _decode_struct(buf, off, ftype, fields, types)
        out.append(m)
    return out, off


def _decode_struct(buf: bytes, off: int, ftype: str,
                   fields: Sequence[Field], types: Dict[str, List[Field]]):
    msg = Msg(ftype)
    for fname, fty, alen in fields:
        v, off = _decode_value(buf, off, fty, alen, types)
        setattr(msg, fname, v)
    return msg, off


def _builtin_fields(ftype: str, types: Dict[str, List[Field]]) -> List[Field]:
    """Fall back to the shipped DEFS catalog for sub-types a bag's
    definition text failed to embed (malformed writers exist)."""
    if ftype in DEFS:
        parsed = parse_definition(ftype, full_definition(ftype))
        types.update({k: v for k, v in parsed.items() if k not in types})
        return parsed[ftype]
    raise KeyError(f"unknown message type {ftype!r} (not embedded, not in DEFS)")


def decode_message(msg_type: str, definition: str, data: bytes) -> Msg:
    types = parse_definition(msg_type, definition)
    msg, off = _decode_struct(data, 0, msg_type, types[msg_type], types)
    if off != len(data):
        raise ValueError(
            f"{msg_type}: decoded {off} of {len(data)} bytes — definition "
            "does not match serialized layout")
    return msg


def _get(obj, name, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _encode_value(out: List[bytes], v, ftype: str, alen: Optional[int],
                  types: Dict[str, List[Field]]):
    if ftype in _PRIMITIVES:
        code, _ = _PRIMITIVES[ftype]
        if alen is None:
            if v is None:
                v = 0
            out.append(struct.pack("<" + code,
                                   int(v) if code not in "fd" else float(v)))
            return
        arr = np.asarray(v if v is not None else [],
                         dtype=_NP_DTYPE[ftype]).ravel()
        if alen == -1:
            out.append(_U32.pack(arr.size))
        else:
            if arr.size == 0:
                arr = np.zeros(alen, dtype=_NP_DTYPE[ftype])
            if arr.size != alen:
                raise ValueError(f"fixed array len {alen} != {arr.size}")
        out.append(arr.astype(arr.dtype.newbyteorder("<")).tobytes())
        return
    if ftype == "string":
        if alen is not None:
            items = list(v or [])
            if alen == -1:
                out.append(_U32.pack(len(items)))
            for s in items:
                _encode_value(out, s, "string", None, types)
            return
        b = (v or "").encode("utf-8")
        out.append(_U32.pack(len(b)) + b)
        return
    if ftype in ("time", "duration"):
        if isinstance(v, (int, float)):
            secs = int(v)
            nsecs = int(round((v - secs) * 1e9))
        elif v is None:
            secs = nsecs = 0
        else:
            secs, nsecs = _get(v, "secs", 0), _get(v, "nsecs", 0)
        out.append(_TIME.pack(secs, nsecs))
        return
    fields = types.get(ftype)
    if fields is None:
        fields = _builtin_fields(ftype, types)
    if alen is None:
        _encode_struct(out, v, fields, types)
        return
    items = list(v or [])
    if alen == -1:
        out.append(_U32.pack(len(items)))
    for item in items:
        _encode_struct(out, item, fields, types)


def _encode_struct(out: List[bytes], v, fields: Sequence[Field],
                   types: Dict[str, List[Field]]):
    for fname, fty, alen in fields:
        _encode_value(out, None if v is None else _get(v, fname), fty, alen,
                      types)


def encode_message(msg_type: str, definition: str, msg) -> bytes:
    """Serialize a nested dict / Msg / SimpleNamespace; missing fields
    zero-fill (like rospy's default-constructed messages)."""
    types = parse_definition(msg_type, definition)
    out: List[bytes] = []
    _encode_struct(out, msg, types[msg_type], types)
    return b"".join(out)


# ---------------------------------------------------------------------------
# shipped definition catalog (the types bag2data needs)
# ---------------------------------------------------------------------------

DEFS: Dict[str, str] = {
    "std_msgs/Header": "uint32 seq\ntime stamp\nstring frame_id\n",
    "geometry_msgs/Vector3": "float64 x\nfloat64 y\nfloat64 z\n",
    "geometry_msgs/Point": "float64 x\nfloat64 y\nfloat64 z\n",
    "geometry_msgs/Quaternion":
        "float64 x\nfloat64 y\nfloat64 z\nfloat64 w\n",
    "geometry_msgs/Pose":
        "Point position\nQuaternion orientation\n",
    "geometry_msgs/PoseStamped": "Header header\nPose pose\n",
    "geometry_msgs/PoseWithCovariance":
        "Pose pose\nfloat64[36] covariance\n",
    "geometry_msgs/Twist":
        "Vector3 linear\nVector3 angular\n",
    "geometry_msgs/TwistStamped": "Header header\nTwist twist\n",
    "geometry_msgs/TwistWithCovariance":
        "Twist twist\nfloat64[36] covariance\n",
    "geometry_msgs/Transform":
        "Vector3 translation\nQuaternion rotation\n",
    "geometry_msgs/TransformStamped":
        "Header header\nstring child_frame_id\nTransform transform\n",
    "nav_msgs/Odometry":
        "Header header\nstring child_frame_id\n"
        "PoseWithCovariance pose\nTwistWithCovariance twist\n",
    "sensor_msgs/Image":
        "Header header\nuint32 height\nuint32 width\nstring encoding\n"
        "uint8 is_bigendian\nuint32 step\nuint8[] data\n",
    "sensor_msgs/CompressedImage":
        "Header header\nstring format\nuint8[] data\n",
    "sensor_msgs/Imu":
        "Header header\nQuaternion orientation\n"
        "float64[9] orientation_covariance\nVector3 angular_velocity\n"
        "float64[9] angular_velocity_covariance\n"
        "Vector3 linear_acceleration\n"
        "float64[9] linear_acceleration_covariance\n",
    "sensor_msgs/RegionOfInterest":
        "uint32 x_offset\nuint32 y_offset\nuint32 height\nuint32 width\n"
        "bool do_rectify\n",
    "sensor_msgs/CameraInfo":
        "Header header\nuint32 height\nuint32 width\n"
        "string distortion_model\nfloat64[] D\nfloat64[9] K\nfloat64[9] R\n"
        "float64[12] P\nuint32 binning_x\nuint32 binning_y\n"
        "RegionOfInterest roi\n",
    "tf2_msgs/TFMessage": "geometry_msgs/TransformStamped[] transforms\n",
}

_DEPS: Dict[str, Tuple[str, ...]] = {
    "geometry_msgs/Pose": ("geometry_msgs/Point", "geometry_msgs/Quaternion"),
    "geometry_msgs/PoseStamped": ("std_msgs/Header", "geometry_msgs/Pose"),
    "geometry_msgs/PoseWithCovariance": ("geometry_msgs/Pose",),
    "geometry_msgs/Twist": ("geometry_msgs/Vector3",),
    "geometry_msgs/TwistStamped": ("std_msgs/Header", "geometry_msgs/Twist"),
    "geometry_msgs/TwistWithCovariance": ("geometry_msgs/Twist",),
    "geometry_msgs/Transform":
        ("geometry_msgs/Vector3", "geometry_msgs/Quaternion"),
    "geometry_msgs/TransformStamped":
        ("std_msgs/Header", "geometry_msgs/Transform"),
    "nav_msgs/Odometry":
        ("std_msgs/Header", "geometry_msgs/PoseWithCovariance",
         "geometry_msgs/TwistWithCovariance"),
    "sensor_msgs/Image": ("std_msgs/Header",),
    "sensor_msgs/CompressedImage": ("std_msgs/Header",),
    "sensor_msgs/Imu":
        ("std_msgs/Header", "geometry_msgs/Quaternion",
         "geometry_msgs/Vector3"),
    "sensor_msgs/CameraInfo":
        ("std_msgs/Header", "sensor_msgs/RegionOfInterest"),
    "tf2_msgs/TFMessage": ("geometry_msgs/TransformStamped",),
}

_SEP = "=" * 80


def full_definition(msg_type: str) -> str:
    """Concatenated definition text for `msg_type` (root body + every
    transitive dependency as a `MSG:` block) — the string rosbag stores in
    the connection record's message_definition field."""
    seen: List[str] = []

    def walk(t: str):
        for d in _DEPS.get(t, ()):
            if d not in seen:
                seen.append(d)
                walk(d)

    walk(msg_type)
    parts = [DEFS[msg_type]]
    for d in seen:
        parts.append(f"{_SEP}\nMSG: {d}\n{DEFS[d]}")
    return "\n".join(parts)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class Connection:
    def __init__(self, cid: int, topic: str, msg_type: str, md5sum: str,
                 definition: str):
        self.id = cid
        self.topic = topic
        self.msg_type = msg_type
        self.md5sum = md5sum
        self.definition = definition
        self._types: Optional[Dict[str, List[Field]]] = None

    def decode(self, data: bytes) -> Msg:
        if self._types is None:
            self._types = parse_definition(self.msg_type, self.definition)
        msg, off = _decode_struct(data, 0, self.msg_type,
                                  self._types[self.msg_type], self._types)
        if off != len(data):
            raise ValueError(
                f"{self.msg_type} on {self.topic}: decoded {off} of "
                f"{len(data)} bytes")
        return msg


_MAGIC = b"#ROSBAG V2.0\n"


class BagReader:
    """Whole-file ROS1 v2.0 bag reader (loads the bag into memory, fine for
    capture-session bags; UT-MM sequences are a few GB at most)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            buf = f.read()
        if not buf.startswith(_MAGIC):
            raise ValueError(
                f"{path}: not a ROS1 v2.0 bag (magic {buf[:13]!r})")
        self.connections: Dict[int, Connection] = {}
        # (secs, nsecs, conn_id, raw_bytes)
        self._messages: List[Tuple[int, int, int, bytes]] = []
        for header, data in _iter_records(buf, len(_MAGIC)):
            self._handle_record(header, data)
        self._messages.sort(key=lambda m: (m[0], m[1]))

    def _handle_record(self, header: Dict[str, bytes], data: bytes):
        op = header.get("op", b"\x00")[0]
        if op == _OP_CONN:
            cid = _U32.unpack(header["conn"])[0]
            if cid in self.connections:
                return
            inner = _parse_header(data)
            self.connections[cid] = Connection(
                cid,
                header["topic"].decode(),
                inner.get("type", b"").decode(),
                inner.get("md5sum", b"").decode(),
                inner.get("message_definition", b"").decode(),
            )
        elif op == _OP_CHUNK:
            comp = header.get("compression", b"none").decode()
            if comp == "none":
                blob = data
            elif comp == "bz2":
                blob = bz2.decompress(data)
            elif comp == "lz4":
                try:
                    import lz4.frame  # optional; absent in this image
                except ImportError as e:
                    raise RuntimeError(
                        "bag chunk is lz4-compressed and the lz4 package is "
                        "not installed; re-record with bz2/none or install "
                        "lz4") from e
                blob = lz4.frame.decompress(data)
            else:
                raise ValueError(f"unknown chunk compression {comp!r}")
            for h, d in _iter_records(blob):
                self._handle_record(h, d)
        elif op == _OP_MSG:
            cid = _U32.unpack(header["conn"])[0]
            secs, nsecs = _TIME.unpack(header["time"])
            self._messages.append((secs, nsecs, cid, data))
        # bag header / index / chunk-info records are redundant for a
        # full scan

    @property
    def topics(self) -> Dict[str, str]:
        return {c.topic: c.msg_type for c in self.connections.values()}

    def __len__(self):
        return len(self._messages)

    def read_messages(self, topics: Optional[Sequence[str]] = None
                      ) -> Iterator[Tuple[str, Msg, RosTime]]:
        """Yield (topic, decoded message, record time) in time order —
        the rosbag.Bag.read_messages surface bag2data consumes."""
        want = set(topics) if topics is not None else None
        for secs, nsecs, cid, data in self._messages:
            conn = self.connections[cid]
            if want is not None and conn.topic not in want:
                continue
            yield conn.topic, conn.decode(data), RosTime(secs, nsecs)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class BagWriter:
    """Minimal tool-compatible bag writer: one uncompressed chunk per
    `chunk_threshold` bytes, per-chunk index-data records, trailing
    connection + chunk-info section with the bag header's index_pos
    patched at close. md5sums are written as '*' (we do not implement the
    ROS md5 canonicalization; readers that verify strictly should
    `rosbag reindex`)."""

    def __init__(self, path: str, chunk_threshold: int = 1 << 20,
                 compression: str = "none"):
        if compression not in ("none", "bz2"):
            raise ValueError(f"unsupported compression {compression!r}")
        self._compression = compression
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._hdr_pos = self._f.tell()
        self._write_bag_header(0, 0, 0)   # placeholder, patched at close
        self._conns: Dict[str, int] = {}
        self._defs: Dict[int, Tuple[str, str]] = {}
        self._conn_records: List[bytes] = []
        self._chunk: List[bytes] = []
        self._chunk_size = 0   # running byte total of self._chunk —
        #   message offsets inside a chunk are needed per write and a
        #   sum() over the record list is O(n^2) per chunk
        self._chunk_index: Dict[int, List[Tuple[int, int, int]]] = {}
        self._chunk_infos: List[bytes] = []
        self._chunk_threshold = chunk_threshold
        self._closed = False

    # -- records -----------------------------------------------------------
    @staticmethod
    def _record(fields: Dict[str, bytes], data: bytes) -> bytes:
        h = _pack_header(fields)
        return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data

    def _write_bag_header(self, index_pos: int, conn_count: int,
                          chunk_count: int):
        fields = {
            "op": bytes([_OP_BAGHDR]),
            "index_pos": _U64.pack(index_pos),
            "conn_count": _U32.pack(conn_count),
            "chunk_count": _U32.pack(chunk_count),
        }
        h = _pack_header(fields)
        # rosbag pads the bag header record to 4096 bytes via its data
        pad = 4096 - (4 + len(h) + 4)
        self._f.write(_U32.pack(len(h)) + h + _U32.pack(pad) + b" " * pad)

    # -- public API --------------------------------------------------------
    def add_connection(self, topic: str, msg_type: str,
                       definition: Optional[str] = None) -> int:
        if topic in self._conns:
            return self._conns[topic]
        if definition is None:
            definition = full_definition(msg_type)
        cid = len(self._conns)
        self._conns[topic] = cid
        inner = _pack_header({
            "topic": topic.encode(),
            "type": msg_type.encode(),
            "md5sum": b"*",
            "message_definition": definition.encode(),
        })
        rec = self._record(
            {"op": bytes([_OP_CONN]), "conn": _U32.pack(cid),
             "topic": topic.encode()}, inner)
        self._conn_records.append(rec)
        self._chunk.append(rec)
        self._chunk_size += len(rec)
        self._defs[cid] = (msg_type, definition)
        return cid

    def write(self, topic: str, msg, t: float | RosTime,
              msg_type: Optional[str] = None):
        """Serialize `msg` (nested dict / Msg) on `topic` at time `t`.
        The topic must have been added (or msg_type given for auto-add)."""
        if topic not in self._conns:
            if msg_type is None:
                raise KeyError(f"unknown topic {topic!r}; call "
                               "add_connection or pass msg_type")
            self.add_connection(topic, msg_type)
        cid = self._conns[topic]
        mtype, definition = self._defs[cid]
        data = encode_message(mtype, definition, msg)
        if isinstance(t, RosTime):
            secs, nsecs = t.secs, t.nsecs
        else:
            secs = int(t)
            nsecs = int(round((t - secs) * 1e9))
        offset = self._chunk_size
        rec = self._record(
            {"op": bytes([_OP_MSG]), "conn": _U32.pack(cid),
             "time": _TIME.pack(secs, nsecs)}, data)
        self._chunk.append(rec)
        self._chunk_size += len(rec)
        self._chunk_index.setdefault(cid, []).append((secs, nsecs, offset))
        if offset + len(rec) >= self._chunk_threshold:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._chunk_index:      # no messages since the last flush
            return
        blob = b"".join(self._chunk)
        chunk_pos = self._f.tell()
        payload = bz2.compress(blob) if self._compression == "bz2" else blob
        self._f.write(self._record(
            {"op": bytes([_OP_CHUNK]),
             "compression": self._compression.encode(),
             "size": _U32.pack(len(blob))}, payload))
        times = [(s, ns) for idx in self._chunk_index.values()
                 for s, ns, _ in idx]
        for cid, idx in sorted(self._chunk_index.items()):
            data = b"".join(_TIME.pack(s, ns) + _U32.pack(off)
                            for s, ns, off in idx)
            self._f.write(self._record(
                {"op": bytes([_OP_INDEX]), "ver": _U32.pack(1),
                 "conn": _U32.pack(cid), "count": _U32.pack(len(idx))},
                data))
        if times:
            start, end = min(times), max(times)
        else:
            start = end = (0, 0)
        info_data = b"".join(
            _U32.pack(cid) + _U32.pack(len(idx))
            for cid, idx in sorted(self._chunk_index.items()))
        self._chunk_infos.append(self._record(
            {"op": bytes([_OP_CHUNKINFO]), "ver": _U32.pack(1),
             "chunk_pos": _U64.pack(chunk_pos),
             "start_time": _TIME.pack(*start),
             "end_time": _TIME.pack(*end),
             "count": _U32.pack(len(self._chunk_index))}, info_data))
        # each chunk must carry the connection records of the messages it
        # contains (rosbag's own layout); seed the next chunk with all
        self._chunk = list(self._conn_records)
        self._chunk_size = sum(len(r) for r in self._chunk)
        self._chunk_index = {}

    def close(self):
        if self._closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        for rec in self._conn_records:
            self._f.write(rec)
        for rec in self._chunk_infos:
            self._f.write(rec)
        self._f.seek(self._hdr_pos)
        self._write_bag_header(index_pos, len(self._conns),
                               len(self._chunk_infos))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# static-TF resolution (offline equivalent of tf.TransformListener)
# ---------------------------------------------------------------------------

def quat_to_matrix(qx: float, qy: float, qz: float, qw: float) -> np.ndarray:
    n = (qx * qx + qy * qy + qz * qz + qw * qw) or 1.0
    s = 2.0 / n
    return np.array([
        [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw),
         s * (qx * qz + qy * qw)],
        [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz),
         s * (qy * qz - qx * qw)],
        [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw),
         1 - s * (qx * qx + qy * qy)],
    ])


def matrix_to_quat(R: np.ndarray) -> Tuple[float, float, float, float]:
    """(qx, qy, qz, qw), branch on the largest diagonal term."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return (float((R[2, 1] - R[1, 2]) / s),
                float((R[0, 2] - R[2, 0]) / s),
                float((R[1, 0] - R[0, 1]) / s), float(s / 4))
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = [0.0, 0.0, 0.0, float((R[k, j] - R[j, k]) / s)]
    q[i] = s / 4
    q[j] = float((R[j, i] + R[i, j]) / s)
    q[k] = float((R[k, i] + R[i, k]) / s)
    return q[0], q[1], q[2], q[3]


def _tf_matrix(tr) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(tr.rotation.x, tr.rotation.y, tr.rotation.z,
                               tr.rotation.w)
    T[:3, 3] = (tr.translation.x, tr.translation.y, tr.translation.z)
    return T


def lookup_static_transform(bag: BagReader, target: str, source: str,
                            topics: Sequence[str] = ("/tf_static", "/tf"),
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Resolve the source->target frame transform over the bag's TF tree
    (latest transform per edge; chains through intermediate frames by BFS).
    Returns (t[3], q[4] xyzw) like tf.TransformListener.lookupTransform —
    the matrix T_target_source that maps source-frame coordinates into the
    target frame (bag2data.py:49-61's tf.txt writer contract).

    A tf2_msgs/TFMessage transform with header.frame_id=P and
    child_frame_id=C carries T_P_C (child coords -> parent coords)."""
    # adjacency: frame -> [(neighbor, E)] with E mapping frame coords into
    # neighbor coords
    adj: Dict[str, Dict[str, np.ndarray]] = {}
    for _, msg, _ in bag.read_messages([t for t in topics
                                        if t in bag.topics]):
        for tr in msg.transforms:
            parent = tr.header.frame_id.lstrip("/")
            child = tr.child_frame_id.lstrip("/")
            T_pc = _tf_matrix(tr.transform)
            adj.setdefault(child, {})[parent] = T_pc          # c -> p
            adj.setdefault(parent, {})[child] = np.linalg.inv(T_pc)
    target, source = target.lstrip("/"), source.lstrip("/")
    if source == target:
        return np.zeros(3), np.array([0.0, 0.0, 0.0, 1.0])
    # BFS from source, tracking M[frame] = T_frame_source
    M: Dict[str, np.ndarray] = {source: np.eye(4)}
    queue = [source]
    while queue:
        frame = queue.pop(0)
        for nbr, E in adj.get(frame, {}).items():
            if nbr in M:
                continue
            M[nbr] = E @ M[frame]
            if nbr == target:
                T = M[nbr]
                return T[:3, 3].copy(), np.array(matrix_to_quat(T[:3, :3]))
            queue.append(nbr)
    raise KeyError(
        f"no TF chain from {source!r} to {target!r} in topics "
        f"{[t for t in topics if t in bag.topics]}")
