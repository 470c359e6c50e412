"""p3m_refreshes_per_replay: the program's auto-refresh rewinds
(BodySystem.p3m_refreshes) over the window, per replay of the initial state."""


def read(rec):
    if rec.get("p3m_refreshes") is None or not rec.get("replays"):
        return None
    return rec["p3m_refreshes"] / rec["replays"]
