"""Compliant twin of ``violation_pool.py``."""


class DraftRunner:
    def propose(self, req, k):
        if req.id not in self._pos:
            self.pool.alloc_pages(req.id, 0, owner="draft")
            self._pos[req.id] = 0                       # published
        self.pool.ensure(req.id, req.context_len + k - 1)

    def admit(self, req):
        if req.prompt_len > self.max_len:
            raise ValueError("too long")
        table = self.pool.alloc(req.id, req.prompt_len)
        self.tables[req.id] = table

    def drop(self, req_id):
        self.pool.free_seq(req_id)
