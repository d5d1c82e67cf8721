"""The fullest page server's high-water mark as a share of its pool
(``KVStats.pages_highwater`` over ``pool_pages``)."""


def read(ctx):
    shares = [100.0 * v["pages_highwater"] / v["pool_pages"]
              for v in (ctx.get("kv") or {}).values() if v["pool_pages"]]
    return max(shares) if shares else None
