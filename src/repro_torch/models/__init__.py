"""Model math of the port: dense GQA transformers over paged KV."""
