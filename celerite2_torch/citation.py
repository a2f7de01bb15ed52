"""Citation bookkeeping for the celerite method papers.

Counterpart of ``celerite2_tpu/citation.py``, kept as the port's own
copy.  ``CITATIONS`` maps citation keys to BibTeX entries;
:func:`get_citations` collects the entries relevant to a model (keys can
be extended by downstream integrations).
"""

from __future__ import annotations

__all__ = ["CITATIONS", "CITATION_KEYS", "get_citations"]

CITATION_KEYS = (
    "celerite2:foremanmackey17",
    "celerite2:foremanmackey18",
)

CITATIONS = {
    "celerite2:foremanmackey17": r"""
@article{celerite2:foremanmackey17,
   author = {{Foreman-Mackey}, D. and {Agol}, E. and {Ambikasaran}, S.
             and {Angus}, R.},
    title = "{Fast and Scalable Gaussian Process Modeling with
              Applications to Astronomical Time Series}",
  journal = {The Astronomical Journal},
     year = 2017,
   volume = 154,
    pages = {220},
      doi = {10.3847/1538-3881/aa9332},
}
""",
    "celerite2:foremanmackey18": r"""
@article{celerite2:foremanmackey18,
   author = {{Foreman-Mackey}, D.},
    title = "{Scalable Backpropagation for Gaussian Processes using
              Celerite}",
  journal = {Research Notes of the American Astronomical Society},
     year = 2018,
   volume = 2,
   number = 1,
    pages = {31},
      doi = {10.3847/2515-5172/aaaf6c},
}
""",
}


def get_citations(*extra_keys: str) -> str:
    """BibTeX for the method papers (+ any registered extra keys)."""
    keys = list(CITATION_KEYS) + [
        k for k in extra_keys if k in CITATIONS
    ]
    return "\n".join(CITATIONS[k] for k in dict.fromkeys(keys))
