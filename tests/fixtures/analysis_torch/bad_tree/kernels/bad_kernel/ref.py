"""Known-bad plain version for the launch audit's fixtures: it takes no
``window`` (the wrapper threads one) and never reads ``pages_start``."""


def bad_attention_ref(q, k_pages, v_pages, page_table, seq_lens,
                      pages_bound=None, pages_start=0):
    end = page_table.shape[1] if pages_bound is None else pages_bound
    return q[:, :, :, :end]
