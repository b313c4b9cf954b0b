"""The Block-NeRF TFRecord -> PNG extractor (counterpart of
ingp_tpu/data/block.py), a standalone tool outside the dataset registry,
as in JAX. The Waymo Block-NeRF release stores frames as TFRecords of
tf.train.Example protos; this parses the TFRecord framing and the
Example wire format itself (varints and length-delimited fields, CRCs
not checked), and decodes each image's bytes with the port's own PNG or
JPEG reader, chosen by their signature, then writes it with write_png."""
from __future__ import annotations

import os
import struct

import numpy as np

from .image_io import decode_bytes, write_png


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def iter_tfrecord(path):
    """Yield the payload bytes of each record of a TFRecord file (uint64
    length, uint32 length CRC, payload, uint32 payload CRC)."""
    with open(path, "rb") as f:
        while True:
            head = f.read(8)
            if len(head) < 8:
                return
            (length,) = struct.unpack("<Q", head)
            f.read(4)
            payload = f.read(length)
            f.read(4)
            yield payload


def _parse_feature(fbuf):
    """The values of one Feature: a bytes_list (field 1), float_list (2)
    or int64_list (3), packed or not."""
    pos = 0
    while pos < len(fbuf):
        tag, pos = _read_varint(fbuf, pos)
        field = tag >> 3
        ln, pos = _read_varint(fbuf, pos)
        body = fbuf[pos:pos + ln]
        pos += ln
        vals = []
        bpos = 0
        while bpos < len(body):
            vtag, bpos = _read_varint(body, bpos)
            vwire = vtag & 7
            if vwire == 2:  # length-delimited
                vlen, bpos = _read_varint(body, bpos)
                chunk = body[bpos:bpos + vlen]
                bpos += vlen
                if field == 1:
                    vals.append(chunk)
                elif field == 2:
                    vals.extend(np.frombuffer(chunk, "<f4").tolist())
                elif field == 3:
                    p2 = 0
                    while p2 < len(chunk):
                        v, p2 = _read_varint(chunk, p2)
                        vals.append(v)
            elif vwire == 0:
                v, bpos = _read_varint(body, bpos)
                vals.append(v)
            elif vwire == 5:
                vals.append(struct.unpack("<f", body[bpos:bpos + 4])[0])
                bpos += 4
        return vals
    return []


def parse_example(buf):
    """A tf.train.Example -> {key: list of bytes, ints or floats}
    (Example{features: Features{feature: map<string, Feature>}})."""
    out = {}
    pos = 0
    while pos < len(buf):
        _, pos = _read_varint(buf, pos)
        ln, pos = _read_varint(buf, pos)
        features = buf[pos:pos + ln]
        pos += ln
        fpos = 0
        while fpos < len(features):
            _, fpos = _read_varint(features, fpos)
            fln, fpos = _read_varint(features, fpos)
            entry = features[fpos:fpos + fln]
            fpos += fln
            # map entry: field 1 the key (string), field 2 the Feature
            epos = 0
            key = None
            while epos < len(entry):
                etag, epos = _read_varint(entry, epos)
                eln, epos = _read_varint(entry, epos)
                body = entry[epos:epos + eln]
                epos += eln
                if etag >> 3 == 1:
                    key = body.decode("utf-8")
                else:
                    out[key] = _parse_feature(body)
    return out


def extract_block_images(tfrecord_paths, out_dir,
                         image_key="image", index_key="image_hash"):
    """Write the encoded image of every record that has one to
    out_dir/<index_key value, else its running count>.png; returns how
    many were written."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for path in tfrecord_paths:
        for rec in iter_tfrecord(path):
            ex = parse_example(rec)
            if image_key not in ex or not ex[image_key]:
                continue
            img = decode_bytes(ex[image_key][0], f"{path} record {n}")
            name = str(ex.get(index_key, [n])[0])
            write_png(os.path.join(out_dir, f"{name}.png"), img)
            n += 1
    return n
