"""Back-translation pair filters: digit consistency, <=5 word length gap,
end-punctuation propagation (reference scripts/filter_bt_data.py).
argv: src dst lang output   (lang 'ar' switches Arabic punctuation)"""
import re
import sys

def main():
    src_file, dst_file, lang, out = sys.argv[1:5]
    punct = ".!?" if lang != "ar" else ".!؟"
    n = 0
    with open(src_file) as r1, open(dst_file) as r2, open(out, "w") as w:
        for s, t in zip(r1, r2):
            s, t = s.strip(), t.strip()
            s_nums = re.findall(r"\d+", s)
            t_nums = re.findall(r"\d+", t)
            if bool(s_nums) != bool(t_nums) or s_nums != t_nums:
                continue
            if abs(len(s.split(" ")) - len(t.split(" "))) > 5:
                continue
            for i, mark in enumerate(".!?"):
                if s.endswith(mark) and not t.endswith(mark):
                    t += punct[i]
                    break
            w.write(s + " ||| " + t + "\n")
            n += 1
    print("Done!", n)

if __name__ == "__main__":
    main()
