from repro_torch.sampling.sampler import (
    GenerateOutput, batch_invariant, decode_megastep_rows, decode_paged,
    decode_step_rows, fork_pages, generate, generate_samples,
    member_row_keys, prefill_chunk_paged, prefill_paged, probe_row_keys,
    sample_token, sample_token_rows, tile_cache)

__all__ = ["GenerateOutput", "batch_invariant", "decode_megastep_rows",
           "decode_paged", "decode_step_rows", "fork_pages", "generate",
           "generate_samples", "member_row_keys", "prefill_chunk_paged",
           "prefill_paged", "probe_row_keys", "sample_token",
           "sample_token_rows", "tile_cache"]
