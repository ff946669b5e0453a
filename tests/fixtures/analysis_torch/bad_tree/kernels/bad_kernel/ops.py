"""Known-bad kernel wrappers for the launch audit's fixtures: each hands
the C entry of csrc/bad_kernel.cu (never compiled) something its
signature or its operands do not allow. Nothing is ever launched: the
audit's shims capture the calls."""
import torch

from repro_torch.kernels.common import check_inputs, launch, query

NAME = "bad_kernel"


def _launch(q, k_pages, v_pages, page_table, seq_lens, *ints):
    check_inputs(NAME, {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                 {"page_table": page_table, "seq_lens": seq_lens})
    out = torch.empty_like(q)
    launch(NAME, "bad_attention_f32", q, k_pages, v_pages, page_table,
           seq_lens, out, *ints)
    return out


def _geometry(q, k_pages, page_table):
    B, K, G, D = q.shape
    return B, K, G, D, k_pages.shape[1], page_table.shape[1]


def good(q, k_pages, v_pages, page_table, seq_lens, *, pages_bound=None,
         pages_start=0, window=0):
    """Right: the audit finds nothing in what it passes (a caller's page
    table may still break the walk)."""
    B, K, G, D, ps, MP = _geometry(q, k_pages, page_table)
    end = MP if pages_bound is None else pages_bound
    return _launch(q, k_pages, v_pages, page_table, seq_lens, B, K, G, D,
                   ps, MP, pages_start, end, window)


def short_count(q, k_pages, v_pages, page_table, seq_lens):
    """kernel-abi: forgets the window, one argument short."""
    B, K, G, D, ps, MP = _geometry(q, k_pages, page_table)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, B, K, G, D,
                   ps, MP, 0, MP)


def float_table(q, k_pages, v_pages, page_table, seq_lens):
    """kernel-abi: the page table as floats where the source says
    const int*."""
    B, K, G, D, ps, MP = _geometry(q, k_pages, page_table)
    return _launch(q, k_pages, v_pages, page_table.float(), seq_lens, B, K,
                   G, D, ps, MP, 0, MP, 0)


def wide_head(q, k_pages, v_pages, page_table, seq_lens):
    """kernel-extent: a head_dim 8 wider than the tensors': the kernel
    reads past every float operand."""
    B, K, G, D, ps, MP = _geometry(q, k_pages, page_table)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, B, K, G,
                   D + 8, ps, MP, 0, MP, 0)


def one_page(q, k_pages, v_pages, page_table, seq_lens):
    """kernel-page-walk: walks one page whatever the lengths."""
    B, K, G, D, ps, MP = _geometry(q, k_pages, page_table)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, B, K, G, D,
                   ps, MP, 0, 1, 0)


def unsized(q):
    """kernel-abi: a query with a float where the source says int."""
    return query(NAME, "bad_unreached_bytes", 2.5)
