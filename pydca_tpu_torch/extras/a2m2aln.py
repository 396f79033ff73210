"""A2M → aligned-FASTA converter (reference: ``pydca/extras/a2m2aln.pl``).

The port's copy of ``pydca_tpu/extras/a2m2aln.py`` (the port imports
nothing of the JAX package); the console script ``a2m2aln-torch`` runs
:func:`run_a2m2aln`.

Reformats `A2M <http://compbio.soe.ucsc.edu/a2m-desc.html>`_ alignments to the
simple aligned format the DCA engines consume: the first sequence whose
identifier matches the ``--query`` regular expression defines the match
columns (the positions where it carries an uppercase letter,
``a2m2aln.pl:38-43``); every sequence is reduced to those columns, the query
emitted first (``a2m2aln.pl:25-36,52-64``).  Sequences whose aligned length
differs from the query's are skipped with a warning (``a2m2aln.pl:55-59``).

Kept reference quirks: output identifiers carry a leading ``.``
(``print ">.$seq->[0]"``, ``a2m2aln.pl:62``), and an optional first capture
group in the query regex is parsed as the query start position (exposed on the
result, not printed — the reference computes-then-comments-out the header too,
``a2m2aln.pl:29,44-48``).
"""

from __future__ import annotations

import argparse
import re
import sys
from typing import Iterable, List, Optional, TextIO, Tuple

__all__ = ["A2MResult", "read_a2m_records", "convert_a2m", "run_a2m2aln"]


class A2MResult:
    """Converted alignment: ``records`` is a list of (id, seq) with the query
    first; ``query_start`` is the integer captured by the query regex's first
    group, if any."""

    def __init__(self, records, query_start, skipped):
        self.records: List[Tuple[str, str]] = records
        self.query_start: Optional[int] = query_start
        self.skipped: List[str] = skipped


def read_a2m_records(lines: Iterable[str]) -> List[Tuple[str, str]]:
    """Parse FASTA-ish input: lines before the first ``>`` are ignored, wrapped
    sequence lines are concatenated (``a2m2aln.pl:69-92``)."""
    records: List[Tuple[str, str]] = []
    desc: Optional[str] = None
    seq_parts: List[str] = []
    for raw in lines:
        line = raw.rstrip("\n").rstrip("\r")
        if line.startswith(">"):
            if desc is not None:
                records.append((desc, "".join(seq_parts)))
            desc = line[1:]
            seq_parts = []
        elif desc is not None:
            seq_parts.append(line)
    if desc is not None:
        records.append((desc, "".join(seq_parts)))
    return records


def convert_a2m(
    lines: Iterable[str], query_regex: str, *, quiet: bool = False,
    warn: Optional[TextIO] = None,
) -> A2MResult:
    pattern = re.compile(query_regex)
    records = read_a2m_records(lines)

    query: Optional[Tuple[str, str]] = None
    query_start: Optional[int] = None
    ordered: List[Tuple[str, str]] = []
    for rec in records:
        m = None if query is not None else pattern.search(rec[0])
        if m is not None:
            # first match only (a2m2aln.pl:27-31); group 1, if present and
            # participating, is the query start position
            if m.lastindex:
                g = m.group(1)
                query_start = int(g) if g is not None else None
            query = rec
            ordered.insert(0, rec)
        else:
            ordered.append(rec)
    if query is None:
        raise ValueError(
            f"no sequence identifier matches query regex {query_regex!r}"
        )

    qseq = query[1]
    cols = [i for i, c in enumerate(qseq) if c.isupper() and c.isalpha()]

    out: List[Tuple[str, str]] = []
    skipped: List[str] = []
    for desc, seq in ordered:
        if len(seq) != len(qseq):
            skipped.append(desc)
            if not quiet and warn is not None:
                warn.write(
                    f"length of aligned sequence '{desc}' ({len(seq)}) does "
                    f"not equal to query length ({len(qseq)}), skipping "
                    "sequence\n"
                )
            continue
        out.append((f".{desc}", "".join(seq[i] for i in cols)))
    return A2MResult(out, query_start, skipped)


def run_a2m2aln(argv=None, stdin: Optional[TextIO] = None,
                stdout: Optional[TextIO] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="a2m2aln",
        description="reformat A2M input to a simple aligned FASTA "
        "(reads stdin, writes stdout)",
    )
    parser.add_argument(
        "--query", "-q", required=True,
        help="query identifier regex, e.g. '^RASH_HUMAN/(\\d+)'; an optional "
        "first capture group is the query start position",
    )
    parser.add_argument("--quiet", action="store_true",
                        help="suppress skipped-sequence warnings")
    args = parser.parse_args(argv)
    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    res = convert_a2m(stdin, args.query, quiet=args.quiet, warn=sys.stderr)
    for ident, seq in res.records:
        stdout.write(f">{ident}\n{seq}\n")
    return 0


if __name__ == "__main__":
    sys.exit(run_a2m2aln())
