"""Quorum-replicated owner election with fenced leases — the PD/etcd analog.

Reference parity: the reference keeps ``owner.Manager`` pluggable over an
etcd campaign (pkg/owner/manager.go:49) precisely so a real deployment swaps
in a quorum backend. This module IS that backend for the sharded fleet:
lease/term state replicates to a **majority of store shards** instead of
pinning to shard 0, so losing any single shard — including shard 0 — no
longer halts the control plane, and split-brain stays impossible by
construction.

Protocol (a fenced-lease election, the etcd-lease/raft-term hybrid every
PD-shaped control plane runs):

- Each store shard hosts an :class:`ElectionReplica`: per key it records
  ``(term, owner_id, deadline)``. The **term is the fencing token** — it
  increases monotonically on every ownership grant and never regresses.
- Replica accept rule: a proposal is accepted iff its term is HIGHER than
  the local term, or it matches the local term AND comes from the recorded
  owner (a renewal/vacate). First writer wins within a term; two candidates
  proposing the same new term can therefore never both assemble a majority
  (any two majorities intersect, and the shared replica accepted only one).
- ``campaign`` reads a majority, takes the highest-term record as truth,
  and only proposes ``term+1`` when that record is vacant or its lease has
  expired; while a lease is live, the client rule alone keeps competitors
  out, and past expiry the per-replica first-wins rule decides the race.
- ``renew`` (a campaign carrying the fencing token) re-proposes the SAME
  term: accepted only where the proposer is still the recorded owner, so a
  deposed owner's renewals die at every replica that has seen the new term
  — majority acceptance is impossible once a successor was elected.
- A minority partition can neither grant nor refresh a lease: every verb
  needs a majority of replicas to answer, and fewer surfaces
  ``ConnectionError`` (the etcd-quorum-loss behavior — owners keep their
  last verdict until the lease runs out, then self-fence).
- Dead shards are skipped under the existing retry layer (each store's own
  boRPC Backoffer bounds the probe); replicas that return behind the fleet
  are **read-repaired** to the highest-term record during the next sweep.

Deadlines are wall-clock (``time.time()``) because they cross process
boundaries; the same-host clock assumption is the one the fleet TSO already
documents (kv/sharded.py module docstring). An owner whose lease expired
must re-campaign at a fresh term — same-term renewal past expiry is exactly
the window where a competitor may already be assembling a majority.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional

from tidb_tpu_torch.utils import eventlog as _ev
from tidb_tpu_torch.utils.backoff import Backoffer, BackoffExhausted, boStoreDown

# campaign outcomes worth waking a reader: a grant and a fencing are state
# transitions; renewals/losses are steady-state churn and stay at debug
_OUTCOME_LEVEL = {"won": _ev.INFO, "fenced": _ev.WARN}


def _campaign_event(outcome: str, key: str, node_id: str, term: int) -> None:
    lvl = _OUTCOME_LEVEL.get(outcome, _ev.DEBUG)
    lg = _ev.on(lvl)
    if lg is not None:
        lg.emit(lvl, "election", outcome, key=key, node=node_id, term=term)


@dataclass
class _Record:
    term: int = 0
    owner_id: Optional[str] = None
    deadline: float = 0.0  # wall-clock epoch seconds; 0 = vacated


class ElectionReplica:
    """One shard's share of the election keyspace (the etcd-member role).

    Deliberately dumb: it enforces only the term/ownership accept rule and
    stores what it accepted. All lease reasoning (expiry, who may bump the
    term) lives client-side in :class:`QuorumElection` — replicas must stay
    symmetric so a majority of ANY of them reconstructs the truth."""

    def __init__(self):
        self._mu = threading.Lock()
        self._records: dict[str, _Record] = {}

    def propose(self, key: str, node_id: str, term: int, deadline: float) -> tuple[bool, int]:
        """→ (accepted, replica's current term). Accept iff ``term`` beats
        the local term, or equals it and ``node_id`` is the recorded owner
        (renew/vacate). Idempotent: re-proposing an accepted record
        re-accepts, so the wire verb is replay-safe."""
        with self._mu:
            rec = self._records.setdefault(key, _Record())
            if term > rec.term or (term == rec.term and node_id == rec.owner_id):
                rec.term = term
                rec.owner_id = node_id
                rec.deadline = deadline
                return True, rec.term
            return False, rec.term

    def read(self, key: str) -> tuple[int, Optional[str], float]:
        with self._mu:
            rec = self._records.get(key)
            return (rec.term, rec.owner_id, rec.deadline) if rec else (0, None, 0.0)


class QuorumElection:
    """Client half: campaign/renew/resign as quorum writes, owner reads
    resolved from a majority (highest term wins). Holds a REFERENCE to the
    fleet's store list, so authority changes (tests swapping a dead store
    back in) are visible immediately."""

    def __init__(self, stores: list, lease_s: float = 10.0, budget_ms: float = 2000.0):
        self.stores = stores
        self.lease_s = lease_s
        self._budget_ms = budget_ms
        self._mu = threading.Lock()
        # highest term this CLIENT has observed per key — the local
        # monotonicity witness (a regression here would mean split-brain)
        self._seen_terms: dict[str, int] = {}
        # dead-shard cooldowns: shard index → (skip_until, cooldown_s).
        # Probing a dead REMOTE shard burns its whole boRPC reconnect budget
        # (seconds at production defaults), so without a cooldown every
        # keepalive tick would pay it and a renewal could outlast its own
        # lease. Cooldowns back off exponentially (1 s → 15 s), clear on the
        # first successful verb, and are IGNORED the moment a sweep falls
        # below quorum — a possibly-alive shard is always re-probed before
        # this client reports the keyspace unreachable.
        self._down_mu = threading.Lock()
        self._down: dict[int, tuple[float, float]] = {}
        # (key, node_id) → the term of the node's last successful grant or
        # renewal: lets the lease holder learn its fencing token without
        # paying a second majority sweep right after campaigning
        self._granted: dict[tuple[str, str], int] = {}
        # returning-replica anti-entropy hook (``catchup_fn(shard_idx)``):
        # when a shard that was marked down answers again, the hook replays
        # the majority's records onto it BEFORE its reads count toward
        # quorum — a killed-and-restarted-EMPTY replica otherwise rejoins
        # blank and is only read-repaired lazily, key by key (the carried
        # PR-2 gap). ShardedStore installs a replayer covering the meta
        # keyspace, election records, and placement bindings. Best-effort:
        # a failed catch-up leaves the shard to lazy read-repair.
        self.catchup_fn = None
        self._catchup_busy: set[int] = set()

    @property
    def quorum(self) -> int:
        return len(self.stores) // 2 + 1

    # -- dead-shard cooldown -------------------------------------------------
    def _skip(self, i: int) -> bool:
        with self._down_mu:
            ent = self._down.get(i)
            return ent is not None and ent[0] > time.monotonic()

    def _mark_down(self, i: int) -> None:
        with self._down_mu:
            prev = self._down.get(i)
            cd = min(prev[1] * 2.0, 15.0) if prev else 1.0
            self._down[i] = (time.monotonic() + cd, cd)

    def _mark_up(self, i: int) -> None:
        with self._down_mu:
            self._down.pop(i, None)

    def _any_cooldown(self) -> bool:
        with self._down_mu:
            return bool(self._down)

    def _clear_cooldowns(self) -> None:
        # zero the skip deadlines but KEEP the entries: membership in _down
        # is also the "this shard is RETURNING" witness the anti-entropy
        # catch-up keys off — dropping it here would let a restarted-empty
        # shard rejoin without the replay (only _mark_up, after a
        # successful contact ran the catch-up gate, removes an entry)
        with self._down_mu:
            self._down = {i: (0.0, cd) for i, (_, cd) in self._down.items()}

    # -- quorum plumbing ----------------------------------------------------
    def _run_catchup(self, i: int) -> None:
        """Fire the returning-replica hook once per return (guarded against
        re-entry: the hook itself runs majority reads through this client)."""
        with self._down_mu:
            if i in self._catchup_busy:
                return
            self._catchup_busy.add(i)
        try:
            self.catchup_fn(i)
        # the shard flapped again mid-catch-up; lazy read-repair still
        # covers every key the replay missed
        except Exception:  # graftcheck: off=except-swallow
            pass
        finally:
            with self._down_mu:
                self._catchup_busy.discard(i)

    def _sweep_reads(self, key: str):
        """One pass over every replica not in cooldown → ([(idx, (term,
        owner, deadline))], last ConnectionError). Dead shards are skipped;
        each store's own Backoffer already bounded the probe. A shard seen
        DOWN on an earlier sweep that answers now gets the catch-up hook
        replayed onto it (then re-read) before its vote counts — a
        restarted-empty replica must not vote its blank keyspace."""
        out, last = [], None
        for i, st in enumerate(self.stores):
            if self._skip(i):
                continue
            returning = False
            with self._down_mu:
                returning = i in self._down and i not in self._catchup_busy
            try:
                rec = st.election_read(key)
                if returning and self.catchup_fn is not None:
                    self._run_catchup(i)
                    rec = st.election_read(key)  # post-replay state votes
            except ConnectionError as e:
                self._mark_down(i)
                last = e
                continue
            self._mark_up(i)
            out.append((i, rec))
        return out, last

    @staticmethod
    def _resolve(reads, quorum: int):
        """Pick the authoritative record from a read set: highest term, and
        WITHIN that term the owner holding a majority of replicas, if any.
        A same-term split vote (a losing candidate's straggler record on a
        minority) must not outrank the majority-granted record — resolving
        by deadline alone would misreport the owner and fence the legitimate
        winner. With no majority owner visible (partial sweep of a split
        term) the longest deadline wins: the conservative direction, since
        overestimating a lease only delays the next takeover."""
        maxterm = max(r[0] for _, r in reads)
        top = [r for _, r in reads if r[0] == maxterm]
        by_owner: dict = {}
        for r in top:
            by_owner.setdefault(r[1], []).append(r)
        for owner, recs in by_owner.items():
            if owner is not None and len(recs) >= quorum:
                return max(recs, key=lambda r: r[2])
        return max(top, key=lambda r: r[2])

    def _read_majority(self, key: str):
        """Read the key from a majority (backing off on below-quorum sweeps
        until the budget runs out — sweep wall time is charged against the
        budget, since each dead remote shard burns its own reconnect budget
        before surfacing), read-repair stragglers, and return the resolved
        record as ``(term, owner, deadline)``."""
        from tidb_tpu_torch.utils import metrics as _m

        bo = Backoffer(budget_ms=self._budget_ms)
        swept_ms = 0.0
        cleared = False
        while True:
            t0 = time.monotonic()
            reads, last = self._sweep_reads(key)
            swept_ms += (time.monotonic() - t0) * 1000.0
            if len(reads) >= self.quorum:
                break
            if swept_ms >= bo.remaining_ms():
                raise ConnectionError(
                    f"election keyspace below quorum for {key!r}: "
                    f"{len(reads)}/{len(self.stores)} replicas reachable "
                    f"(need {self.quorum}); cannot grant or refresh a lease"
                ) from last
            if not cleared and self._any_cooldown():
                # shards in cooldown may be alive — re-probe everything once
                # before sleeping or giving up
                cleared = True
                self._clear_cooldowns()
                continue
            try:
                bo.backoff(boStoreDown, last)
            except BackoffExhausted:
                raise ConnectionError(
                    f"election keyspace below quorum for {key!r}: "
                    f"{len(reads)}/{len(self.stores)} replicas reachable "
                    f"(need {self.quorum}); cannot grant or refresh a lease"
                ) from last
        wterm, wowner, wdeadline = self._resolve(reads, self.quorum)
        # read repair: a replica that was down during earlier grants answers
        # with a stale term — push the resolved record back (best-effort; its
        # accept rule takes the higher term)
        if wterm > 0 and wowner is not None:
            for i, (term, _, _) in reads:
                if term < wterm:
                    try:
                        self.stores[i].election_propose(key, wowner, wterm, wdeadline)
                        _m.ELECTION_CAMPAIGN.inc(key=key, outcome="repair")
                    except ConnectionError:
                        self._mark_down(i)
        self._note_term(key, wterm)
        return wterm, wowner, wdeadline

    def _propose_majority(self, key: str, node_id: str, term: int, deadline: float) -> bool:
        """Propose to every replica; True iff a majority accepted. Fewer
        than a majority REACHABLE raises (a minority partition must not
        believe it refreshed a lease it can no longer defend). Shards in
        cooldown are skipped — but re-probed once before giving up."""
        for attempt in range(2):
            acks, reached, last = 0, 0, None
            for i, st in enumerate(self.stores):
                if self._skip(i):
                    continue
                with self._down_mu:
                    returning = i in self._down and i not in self._catchup_busy
                try:
                    ok, _ = st.election_propose(key, node_id, term, deadline)
                except ConnectionError as e:
                    self._mark_down(i)
                    last = e
                    continue
                if returning and self.catchup_fn is not None:
                    # a returning replica whose first contact is a PROPOSE
                    # still gets the anti-entropy replay before _mark_up
                    # erases the returning witness — its ack for THIS record
                    # already stands, but its blank keyspace must not vote
                    # in later read sweeps un-caught-up
                    self._run_catchup(i)
                self._mark_up(i)
                reached += 1
                if ok:
                    acks += 1
            if reached >= self.quorum:
                break
            if attempt == 0 and self._any_cooldown():
                self._clear_cooldowns()
                continue
            raise ConnectionError(
                f"election keyspace below quorum for {key!r}: "
                f"{reached}/{len(self.stores)} replicas reachable (need {self.quorum})"
            ) from last
        if acks >= self.quorum:
            self._note_term(key, term)
            with self._mu:
                self._granted[(key, node_id)] = term
            return True
        return False

    def granted_term(self, key: str, node_id: str) -> Optional[int]:
        """The fencing token of ``node_id``'s last successful grant/renewal
        of ``key`` — locally cached, no quorum sweep. None before any grant."""
        with self._mu:
            return self._granted.get((key, node_id))

    def _note_term(self, key: str, term: int) -> None:
        from tidb_tpu_torch.utils import metrics as _m

        with self._mu:
            prev = self._seen_terms.get(key, 0)
            if term > prev:
                self._seen_terms[key] = term
        if term > prev:
            _m.ELECTION_TERM.set(term, key=key)

    # -- election surface ---------------------------------------------------
    def campaign(
        self,
        key: str,
        node_id: str,
        lease_s: Optional[float] = None,
        term: Optional[int] = None,
    ) -> bool:
        """Try to become (or stay) the owner of ``key``.

        With ``term`` given this is a FENCED RENEWAL: it refreshes the lease
        only while the fleet's highest term still equals ``term`` and
        ``node_id`` is its owner — a deposed owner observably fails here
        instead of silently double-running. Without ``term`` it campaigns:
        renewing a live lease we already hold at the current term, or
        proposing ``term+1`` when the key is vacant/expired."""
        from tidb_tpu_torch.utils import metrics as _m

        lease = lease_s if lease_s is not None else self.lease_s
        wterm, wowner, wdeadline = self._read_majority(key)
        now = time.time()
        if term is not None:
            # renewal under the fencing token: any term movement = deposed
            if wterm != term or wowner != node_id or wdeadline <= now:
                _m.ELECTION_CAMPAIGN.inc(key=key, outcome="fenced")
                _campaign_event("fenced", key, node_id, wterm)
                return False
            ok = self._propose_majority(key, node_id, term, now + lease)
            _m.ELECTION_CAMPAIGN.inc(key=key, outcome="renewed" if ok else "fenced")
            _campaign_event("renewed" if ok else "fenced", key, node_id, term)
            return ok
        if wowner == node_id and wterm > 0 and wdeadline > now:
            # still ours and still live: refresh at the same term
            ok = self._propose_majority(key, node_id, wterm, now + lease)
            _m.ELECTION_CAMPAIGN.inc(key=key, outcome="renewed" if ok else "lost")
            _campaign_event("renewed" if ok else "lost", key, node_id, wterm)
            return ok
        if wowner is not None and wowner != node_id and wdeadline > now:
            _m.ELECTION_CAMPAIGN.inc(key=key, outcome="lost")
            _campaign_event("lost", key, node_id, wterm)
            return False  # live lease elsewhere: back off until it expires
        # vacant / expired / our own expired lease: the fencing token bumps.
        # (An expired lease we used to hold gets a NEW term too — same-term
        # re-grant past expiry is the split-brain window, see module doc.)
        ok = self._propose_majority(key, node_id, wterm + 1, now + lease)
        _m.ELECTION_CAMPAIGN.inc(key=key, outcome="won" if ok else "lost")
        _campaign_event("won" if ok else "lost", key, node_id, wterm + 1 if ok else wterm)
        if ok and wowner is not None and wowner != node_id:
            _m.ELECTION_FAILOVER.inc(key=key)
            lg = _ev.on(_ev.WARN)
            if lg is not None:
                lg.emit(
                    _ev.WARN,
                    "election",
                    "failover",
                    key=key,
                    node=node_id,
                    prev_owner=wowner,
                    term=wterm + 1,
                )
        return ok

    def owner(self, key: str) -> Optional[str]:
        term, owner, deadline = self._read_majority(key)
        if term == 0 or owner is None or deadline <= time.time():
            return None
        return owner

    def term(self, key: str) -> int:
        """The current fencing token for ``key`` (majority-resolved)."""
        return self._read_majority(key)[0]

    def resign(self, key: str, node_id: str) -> None:
        """Vacate the lease with a TOMBSTONE at ``term+1`` (owner recorded,
        deadline 0): the next campaigner grants immediately, no lease wait.
        The tombstone burns a term on purpose — a same-term vacate that
        reached only a minority of replicas would be invisible to majority
        reads (the same-term live record wins the highest-(term, deadline)
        resolution), leaving a ghost lease until expiry; the higher-term
        tombstone dominates every stale record the moment a majority has it,
        and read repair spreads it to the rest."""
        wterm, wowner, _ = self._read_majority(key)
        if wowner != node_id or wterm == 0:
            return
        try:
            self._propose_majority(key, node_id, wterm + 1, 0.0)
        except ConnectionError:
            pass  # below quorum: the lease will expire on its own

    def snapshot(self) -> dict:
        """Observability: {key: {owner, term, lease_remaining_s}} for every
        key this client has campaigned or resolved (status server surface)."""
        with self._mu:
            keys = list(self._seen_terms)
        out = {}
        now = time.time()
        for key in keys:
            try:
                term, owner, deadline = self._read_majority(key)
            except ConnectionError as e:
                out[key] = {"error": str(e)}
                continue
            live = deadline > now
            out[key] = {
                "owner": owner if live else None,
                "term": term,
                "lease_remaining_s": round(max(0.0, deadline - now), 3) if live else 0.0,
            }
        return out
