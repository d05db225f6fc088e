"""Seeded HL4xx violations on the port's page-pool calls."""


class DraftRunner:
    def propose(self, req, k):
        self.pool.alloc_pages(req.id, 0, owner="draft")   # HL402
        self.pool.ensure(req.id, req.context_len + k - 1)

    def admit(self, req):
        table = self.pool.alloc(req.id, req.prompt_len)
        if req.prompt_len > self.max_len:
            raise ValueError("too long")                # HL401
        self.tables[req.id] = table
