from repro_torch.sampling.sampler import (
    decode_megastep_rows, decode_step_rows, fork_pages, member_row_keys,
    prefill_chunk_paged, probe_row_keys, sample_token_rows)

__all__ = ["decode_megastep_rows", "decode_step_rows", "fork_pages",
           "member_row_keys", "prefill_chunk_paged", "probe_row_keys",
           "sample_token_rows"]
