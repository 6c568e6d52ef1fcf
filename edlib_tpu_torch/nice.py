"""Human-readable gapped alignment rendering.

Copied from the JAX package: the Python binding's getNiceAlignment
(bindings/python/edlib.pyx:158-238), the same input contract (the dict of
align(task="path")), the same output dict {query_aligned, matched_aligned,
target_aligned}, exceptions on malformed input.
"""

from __future__ import annotations

import re

_CIGAR_RE = re.compile(r"(\d+)(\D)")


def getNiceAlignment(alignResult, query, target, gapSymbol="-"):
    if not isinstance(alignResult, dict):
        raise Exception(
            "The object alignResult is expected to be a python dictionary. "
            "Please check the input alignResult.")
    if "locations" not in alignResult:
        raise Exception(
            "The object alignResult is expected to contain a field "
            "'locations'. Please check the input alignResult.")
    if "cigar" not in alignResult:
        raise Exception(
            "The object alignResult is expected to contain a CIGAR string. "
            "Please check the input alignResult.")
    cigar = alignResult["cigar"]
    if cigar is None or cigar == "":
        raise Exception(
            "The object alignResult contains an empty CIGAR string. Users "
            "must run align() with task='path'. Please check the input "
            "alignResult.")

    # Beyond the reference binding (which requires str): align() accepts
    # bytes, so render them too.
    if isinstance(query, (bytes, bytearray, memoryview)):
        query = bytes(query).decode("latin-1")
    if isinstance(target, (bytes, bytearray, memoryview)):
        target = bytes(target).decode("latin-1")

    target_pos = alignResult["locations"][0][0]
    if target_pos is None:
        target_pos = 0
    query_pos = 0
    q_parts, m_parts, t_parts = [], [], []

    for num_str, op in _CIGAR_RE.findall(cigar):
        n = int(num_str)
        if op == "=":
            t_parts.append(target[target_pos:target_pos + n])
            q_parts.append(query[query_pos:query_pos + n])
            m_parts.append("|" * n)
            target_pos += n
            query_pos += n
        elif op == "X":
            t_parts.append(target[target_pos:target_pos + n])
            q_parts.append(query[query_pos:query_pos + n])
            m_parts.append("." * n)
            target_pos += n
            query_pos += n
        elif op == "D":
            t_parts.append(target[target_pos:target_pos + n])
            q_parts.append(gapSymbol * n)
            m_parts.append(gapSymbol * n)
            target_pos += n
        elif op == "I":
            t_parts.append(gapSymbol * n)
            q_parts.append(query[query_pos:query_pos + n])
            m_parts.append(gapSymbol * n)
            query_pos += n
        else:
            raise Exception(
                "The CIGAR string from alignResult contains a symbol not "
                "'=', 'X', 'D', 'I'. Please check the validity of "
                "alignResult and alignResult.cigar")

    return {
        "query_aligned": "".join(q_parts),
        "matched_aligned": "".join(m_parts),
        "target_aligned": "".join(t_parts),
    }
